"""Front-tier replica router: health-checked registry, circuit breaking,
bounded retries, hedged requests.

The port's copy of ``seist_tpu/serve/router.py``: the same routes,
status codes, headers, counters and JSON shapes. A served replica
(``python -m seist_tpu_torch serve``) is one process; this module makes
N of them a fleet. A thin, model-free HTTP tier (stdlib only: it imports
neither torch nor numpy, and takes no device — it runs in
the supervisor or on a separate box) forwards ``POST /predict`` and
``POST /annotate`` to replica processes and owns the reliability story:

* :class:`ReplicaRegistry` — the routable set. A background prober
  drives it off each replica's ``/healthz/ready`` (the live/ready
  split): a draining or still-warming replica leaves rotation within one
  probe interval, a restarted one re-enters the same way.
  ``seist_tpu_torch/supervise_fleet.py`` also rolls it explicitly over the
  ``POST /router/register`` / ``/router/deregister`` admin endpoints.
* :class:`CircuitBreaker`, per replica — the *fast* path around failure.
  Health probes need seconds and cannot see the worst failure mode at
  all: a black-holed replica that accepts connections (and answers
  probes) but never answers requests. The breaker sees every request
  outcome: consecutive failures (connection errors, per-attempt
  timeouts, 500s) or slow successes past ``latency_trip_ms`` OPEN the
  circuit; after a cooldown one HALF-OPEN probe request is let through;
  success CLOSEs, failure re-opens with doubled cooldown.
* **Bounded retries** — a failed attempt is retried on a *different*
  replica while the per-request retry budget (``retries``) and the
  client's own deadline allow. Replica-crash failures (SIGKILL mid
  flight) become invisible to well-formed clients; shed responses
  (503 ``shed``) are deliberately NOT retried — under fleet-wide
  overload a retry storm is fuel on the fire, so the shed verdict and
  its Retry-After pass through.
* **Hedged requests** (``hedge_ms`` > 0) — tail-latency insurance: if
  the chosen replica hasn't answered within the hedge delay, a second
  attempt races it on another replica and the first acceptable answer
  wins: insurance for the p99 under a latency SLO.

Error classification (drives retry + breaker):

    =====================  ========  =======  ==================
    outcome                breaker   retried  passed to client
    =====================  ========  =======  ==================
    connect/read timeout   failure   yes      504 if budget gone
    connection refused     failure   yes      502 if budget gone
    HTTP 500               failure   yes      after budget
    HTTP 429 queue_full    success   yes      after budget
    HTTP 503 shutting_down success   yes      after budget
    HTTP 503 shed          success   NO       immediately
    HTTP 504 deadline      success   NO       immediately
    HTTP 2xx/4xx           success   NO       immediately
    =====================  ========  =======  ==================

Counters land on the metrics bus (``seist_router_*``, ``obs/bus.py``), scraped from
the router's own ``GET /metrics``.

**Streaming (``POST /stream``) routes differently.** A stream packet is
not stateless: the replica holds the station's session (ring buffer,
picker cursors), so round-robin would shatter every session across the
fleet. :class:`StationAffinity` pins each station to one replica by
rendezvous hash over the *currently routable* set — deterministic (every
router instance computes the same placement, no coordination state),
minimally disruptive (a replica leaving re-homes only ITS stations;
survivors keep theirs). When a replica dies (breaker open, probe-down,
``mark_down``), the next packet's rendezvous simply lands on the
station's highest-ranked survivor, which restores the session from the
shared journal (stream/journal.py) or re-warms through the
gap — ``seist_stream_rehome_total`` counts each adoption. Stream packets
are never hedged or shadow-mirrored: duplicating a stateful packet to a
second replica would fork the session.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import re
import socket
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Dict, List, Optional, Set, Tuple

from seist_tpu_torch.obs import trace as obs_trace
from seist_tpu_torch.serve.canary import (
    CanaryBudget,
    CanaryController,
    ShadowMirror,
    decision_diff,
    serves_version,
)
from seist_tpu_torch.utils.logger import logger

# Breaker states (also the value of the router_breaker_state gauge).
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Per-replica request-outcome circuit breaker.

    CLOSED —(``failures_to_open`` consecutive failures or
    too-slow successes)→ OPEN —(cooldown elapses; next ``allow`` grants
    exactly one probe)→ HALF_OPEN —(probe success)→ CLOSED, or —(probe
    failure)→ OPEN with the cooldown doubled (capped). Thread-safe; the
    clock is injectable for tests."""

    def __init__(
        self,
        failures_to_open: int = 3,
        cooldown_s: float = 2.0,
        max_cooldown_s: float = 30.0,
        latency_trip_ms: float = float("inf"),
        probe_timeout_s: float = 60.0,
        clock=time.monotonic,
    ):
        self.failures_to_open = max(1, int(failures_to_open))
        self.base_cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self.latency_trip_ms = float(latency_trip_ms)
        self.probe_timeout_s = float(probe_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._cooldown_s = self.base_cooldown_s
        self._opened_at = 0.0
        self._half_open_at = 0.0
        self._opens = 0  # lifetime open transitions (stats)

    # ------------------------------------------------------------ decisions
    def allow(self) -> bool:
        """May a request be sent now? In OPEN, the first call after the
        cooldown flips to HALF_OPEN and grants itself the single probe;
        callers that get False must route elsewhere."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self._cooldown_s:
                    self._state = HALF_OPEN
                    self._half_open_at = self._clock()
                    return True  # this caller IS the half-open probe
                return False
            # HALF_OPEN: probe already in flight — unless its outcome was
            # lost (attempt thread outliving every drain window, e.g. a
            # replica trickling bytes so each socket op resets the per-op
            # timeout). Without this escape a lost probe wedges the
            # breaker HALF_OPEN forever and the replica becomes
            # permanently unroutable; re-grant the probe slot instead.
            if self._clock() - self._half_open_at >= self.probe_timeout_s:
                self._half_open_at = self._clock()
                return True
            return False

    def record_success(self, latency_ms: float = 0.0) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                if latency_ms > self.latency_trip_ms:
                    # The probe "succeeded" but is still slower than the
                    # trip latency: the replica is still sick. Closing
                    # here would flood traffic back and reset the
                    # cooldown — keep it OPEN with escalation instead.
                    self._open_locked(escalate=True)
                else:
                    # Probe came back healthy: the replica recovered.
                    self._close_locked()
                return
            if latency_ms > self.latency_trip_ms:
                # A "success" slower than the trip latency is the
                # wedged-but-not-dead signature; count it like a failure
                # so a latency-sick replica opens too.
                self._failure_locked()
            else:
                self._consecutive = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # Probe failed: back to OPEN, longer cooldown.
                self._open_locked(escalate=True)
                return
            self._failure_locked()

    # ------------------------------------------------------------ internals
    def _failure_locked(self) -> None:
        self._consecutive += 1
        if self._state == CLOSED and self._consecutive >= self.failures_to_open:
            self._open_locked(escalate=False)

    def _open_locked(self, escalate: bool) -> None:
        if escalate:
            self._cooldown_s = min(self._cooldown_s * 2.0, self.max_cooldown_s)
        self._state = OPEN
        self._opened_at = self._clock()
        self._opens += 1

    def _close_locked(self) -> None:
        self._state = CLOSED
        self._consecutive = 0
        self._cooldown_s = self.base_cooldown_s

    # --------------------------------------------------------------- stats
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "cooldown_s": self._cooldown_s,
                "opens": self._opens,
            }


@dataclass
class RouterConfig:
    #: additional attempts after the first (per request)
    retries: int = 2
    #: per-attempt cap (seconds) — ALSO the black-hole detection time:
    #: an accepted-but-never-answered request fails after this long and
    #: feeds the breaker, so keep it a small multiple of honest p99
    request_timeout_s: float = 10.0
    #: duplicate a request onto a second replica after this long without
    #: an answer (0 = hedging off)
    hedge_ms: float = 0.0
    #: /healthz/ready probe cadence + timeout
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    #: probe failures before a replica leaves rotation
    probe_fails_down: int = 2
    #: breaker knobs (per replica)
    breaker_failures: int = 3
    breaker_cooldown_s: float = 2.0
    breaker_max_cooldown_s: float = 30.0
    breaker_latency_trip_ms: float = float("inf")


class Replica:
    """One registry entry: probe state + breaker + counters."""

    def __init__(self, url: str, config: RouterConfig):
        self.url = url.rstrip("/")
        self.breaker = CircuitBreaker(
            failures_to_open=config.breaker_failures,
            cooldown_s=config.breaker_cooldown_s,
            max_cooldown_s=config.breaker_max_cooldown_s,
            latency_trip_ms=config.breaker_latency_trip_ms,
            # A probe attempt that hasn't settled within a couple of
            # request timeouts is presumed lost (see allow()).
            probe_timeout_s=2.0 * config.request_timeout_s + 5.0,
        )
        # Optimistic start: a just-registered replica is routable until
        # the first probe says otherwise — the breaker catches a dead one
        # within failures_to_open requests, while a pessimistic start
        # would black out a healthy fleet for one probe interval.
        self.probe_ready = True
        self.probe_state = "unprobed"
        self.probe_fails = 0
        #: {model: served version}, learned from /healthz/ready payloads
        #: — the canary/rollout cohort discriminator. {} until probed.
        self.versions: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.routed = 0
        self.failures = 0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            routed, failures = self.routed, self.failures
        return {
            "url": self.url,
            "ready": self.probe_ready,
            "probe_state": self.probe_state,
            "versions": dict(self.versions),
            "breaker": self.breaker.stats(),
            "routed": routed,
            "failures": failures,
        }

    def count(self, failure: bool) -> None:
        with self._lock:
            self.routed += 1
            if failure:
                self.failures += 1


class ReplicaRegistry:
    """The routable replica set; thread-safe. Pick order is round-robin
    over probe-ready replicas whose breaker admits traffic."""

    def __init__(self, config: Optional[RouterConfig] = None):
        self.config = config or RouterConfig()
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._rr = 0

    def add(self, url: str) -> Replica:
        url = url.rstrip("/")
        with self._lock:
            replica = self._replicas.get(url)
            if replica is None:
                replica = Replica(url, self.config)
                self._replicas[url] = replica
                logger.info(f"[router] registered replica {url}")
            return replica

    def remove(self, url: str) -> bool:
        url = url.rstrip("/")
        with self._lock:
            gone = self._replicas.pop(url, None)
        if gone is not None:
            logger.info(f"[router] deregistered replica {url}")
        return gone is not None

    def mark_down(self, url: str, reason: str = "") -> None:
        """Immediately pull a replica from rotation (the fleet supervisor
        calls this the moment it reaps the process — faster than waiting
        out a probe interval)."""
        with self._lock:
            replica = self._replicas.get(url.rstrip("/"))
        if replica is not None:
            replica.probe_ready = False
            replica.probe_state = f"down({reason})" if reason else "down"

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def pick(
        self,
        exclude: Set[str] = frozenset(),
        versions_pred=None,
    ) -> Optional[Replica]:
        """Round-robin over ready replicas not in ``exclude`` whose
        breaker admits the request (``allow`` may consume the single
        half-open probe slot, so it is asked last, only for the
        candidate actually about to be used). ``versions_pred`` (a
        predicate over the replica's probed ``{model: version}``)
        restricts the pick to one rollout cohort — the canary/shadow
        routing hook."""
        with self._lock:
            candidates = [
                r
                for r in self._replicas.values()
                if r.probe_ready and r.url not in exclude
                and (versions_pred is None or versions_pred(r.versions))
            ]
            if not candidates:
                return None
            start = self._rr % len(candidates)
            self._rr += 1
        for i in range(len(candidates)):
            replica = candidates[(start + i) % len(candidates)]
            if replica.breaker.allow():
                return replica
        return None

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.probe_ready)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [r.snapshot() for r in self.replicas()]


class StationAffinity:
    """Rendezvous-hash station -> replica placement (for ``/stream``).

    Stateless where it can be: the hash ranks every (station, replica)
    pair deterministically, so placement is a pure function of the
    routable set — no placement table to replicate, no rebalance storm
    when a replica bounces. The only state kept is the last observed
    home per station, purely for *accounting*: when a packet lands on a
    different replica than its predecessor, that is a re-home (failover
    or fleet change) and ``seist_stream_rehome_total`` counts it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._homes: Dict[str, str] = {}
        self.rehomes = 0

    @staticmethod
    def score(station_id: str, url: str) -> int:
        """Deterministic rendezvous weight (highest wins)."""
        digest = hashlib.sha1(f"{station_id}|{url}".encode()).digest()
        return int.from_bytes(digest[:8], "big")

    def rank(self, station_id: str, urls) -> List[str]:
        """Replica urls best-first for ``station_id`` (ties by url)."""
        return sorted(
            urls, key=lambda u: (-self.score(station_id, u), u)
        )

    def note(self, station_id: str, url: str) -> Optional[str]:
        """Record that ``station_id``'s packet was answered by ``url``;
        returns the PREVIOUS home iff it changed (a re-home)."""
        with self._lock:
            prev = self._homes.get(station_id)
            self._homes[station_id] = url
            if prev is not None and prev != url:
                self.rehomes += 1
                return prev
        return None

    def snapshot(self) -> Dict[str, Any]:
        """Placement summary published under ``/router/replicas`` — the
        chaos lane reads ``by_replica`` to find the station-heavy
        replica worth killing."""
        with self._lock:
            by_replica: Dict[str, int] = {}
            for url in self._homes.values():
                by_replica[url] = by_replica.get(url, 0) + 1
            return {
                "stations": len(self._homes),
                "rehomes": self.rehomes,
                "by_replica": by_replica,
            }


# --------------------------------------------------------------- outcomes
class _Outcome:
    """One attempt's result. ``status=0`` means a network-level failure
    (no HTTP response): ``error`` holds the reason."""

    __slots__ = ("status", "headers", "body", "error", "latency_ms")

    def __init__(
        self,
        status: int,
        headers: Dict[str, str],
        body: bytes,
        error: str = "",
        latency_ms: float = 0.0,
    ):
        self.status = status
        self.headers = headers
        self.body = body
        self.error = error
        self.latency_ms = latency_ms

    @property
    def is_net_error(self) -> bool:
        return self.status == 0

    def error_code(self) -> str:
        """The serve error taxonomy code from a JSON error body (the
        'shed' vs 'shutting_down' discriminator for 503s)."""
        if not self.body:
            return ""
        try:
            return str(json.loads(self.body.decode()).get("error", ""))
        except (ValueError, UnicodeDecodeError):
            return ""


def _classify(outcome: _Outcome) -> Tuple[bool, bool]:
    """-> (breaker_failure, retryable). See the module-docstring table."""
    if outcome.is_net_error:
        return True, True
    s = outcome.status
    if s >= 500 and s not in (503, 504):
        return True, True
    if s == 429:
        return False, True
    if s == 503:
        # 'shed' = fleet overload policy verdict: retrying elsewhere
        # amplifies the overload that caused it; pass it through.
        return False, outcome.error_code() != "shed"
    return False, False  # 2xx, 4xx, 504


def _classify_label(outcome: _Outcome) -> str:
    """Human-readable classification for the attempt's trace span —
    the module-docstring table's row name."""
    if outcome.is_net_error:
        return "net_error"
    failure, retryable = _classify(outcome)
    if outcome.status == 503 and outcome.error_code() == "shed":
        return "shed_not_retried"
    if failure:
        return "server_error"
    if retryable:
        return "backpressure_retryable"
    return "ok" if outcome.status < 400 else "relayed"


class Router:
    """Transport-free routing core (the HTTP shim below is ~50 lines):
    ``forward()`` runs the pick → attempt → classify → retry/hedge loop
    and returns ``(status, headers, body)`` ready to relay."""

    def __init__(
        self,
        registry: Optional[ReplicaRegistry] = None,
        config: Optional[RouterConfig] = None,
        bus=None,
    ):
        self.config = config or RouterConfig()
        self.registry = registry or ReplicaRegistry(self.config)
        if bus is None:
            from seist_tpu_torch.obs.bus import BUS as bus
        self._bus = bus
        # Live-rollout traffic shifting (serve/canary.py): weighted
        # version-aware canary with auto-rollback, and shadow mirroring
        # of sampled requests to the candidate cohort.
        self.canary = CanaryController()
        self.shadow = ShadowMirror()
        # One-shot handoff: set by the (possibly drain-thread) settle
        # that trips the rollback, consumed by the next forward() so the
        # event always lands on a trace. GIL-atomic bool store.
        self._rollback_to_flag = False
        # Bounds concurrent shadow-mirror threads: a slow/black-holed
        # candidate must not accumulate one blocked thread per mirrored
        # request (overflow is dropped and counted skipped_busy).
        self._mirror_slots = threading.Semaphore(8)
        # Station -> replica placement for the stateful /stream path.
        self.affinity = StationAffinity()
        self._prober: Optional[threading.Thread] = None
        self._stop = threading.Event()
        bus.register_collector("router", self._collect)

    # ------------------------------------------------------------- probing
    def start_prober(self) -> None:
        """Start the background ``/healthz/ready`` prober (idempotent)."""
        if self._prober is not None and self._prober.is_alive():
            return
        self._stop.clear()
        self._prober = threading.Thread(
            target=self._probe_loop, name="router-prober", daemon=True
        )
        self._prober.start()

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
        self._bus.unregister_collector("router", fn=self._collect)

    def _probe_loop(self) -> None:
        # A dead prober freezes the routable set silently: drained
        # replicas would keep taking traffic and restarted ones never
        # re-enter. Survive any per-cycle surprise, and if the loop
        # machinery itself dies, say so loudly before the thread goes
        # (threadlint thread-target-raises).
        try:
            while not self._stop.is_set():
                try:
                    for replica in self.registry.replicas():
                        self._probe_one(replica)
                # a single bad probe cycle must not end probing forever
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"[router] probe cycle failed: {e!r}")
                self._stop.wait(self.config.probe_interval_s)
        except BaseException:
            logger.exception(
                "[router] prober thread died — the routable set is frozen "
                "until the router restarts"
            )
            raise

    def _probe_one(self, replica: Replica) -> None:
        try:
            status, _, body = _http_request(
                replica.url,
                "GET",
                "/healthz/ready",
                timeout_s=self.config.probe_timeout_s,
            )
            replica.probe_fails = 0
            try:
                payload = json.loads(body.decode())
            except (ValueError, UnicodeDecodeError):
                payload = {}
            if not isinstance(payload, dict):
                payload = {}
            versions = payload.get("versions")
            if isinstance(versions, dict):
                # Served model versions ride the ready probe (serve
                # handler) — the canary cohort + rolling-restart
                # convergence signal, refreshed every probe interval.
                replica.versions = versions
            if status == 200:
                replica.probe_ready = True
                replica.probe_state = "ok"
            else:
                replica.probe_ready = False
                replica.probe_state = str(
                    payload.get("status", "not_ready")
                )
        except (OSError, http.client.HTTPException) as e:
            # Connection refused/reset/timeout/half-closed: the process
            # is likely gone. Two strikes before leaving rotation — one
            # lost probe packet must not drain a healthy replica.
            replica.probe_fails += 1
            if replica.probe_fails >= self.config.probe_fails_down:
                replica.probe_ready = False
                replica.probe_state = f"unreachable({type(e).__name__})"

    # ------------------------------------------------------------ forwarding
    def forward(
        self, path: str, body: bytes, traceparent: Optional[str] = None
    ) -> Tuple[int, Dict[str, str], bytes]:
        """Route one inference request; returns (status, headers, body).

        ``traceparent`` continues the client's distributed trace (the
        router mints one when the client didn't — it is the fleet edge):
        every attempt becomes a span in the router's trace ring
        (replica, breaker state, classification), retries/hedges flag
        the trace for tail retention, and the response carries the
        router's ``Server-Timing`` total plus the ``traceparent`` echo."""
        rt = obs_trace.RequestTrace(
            traceparent, name=f"router:{path}", process="router"
        )
        if path == "/stream":
            status, headers, payload = self._forward_stream(path, body, rt)
        else:
            status, headers, payload = self._forward_routed(path, body, rt)
        if self._rollback_to_flag:
            # The canary auto-rollback fired during this request's
            # routing: flag its trace (tail-retained) so the event is
            # findable from /traces, not just the bus counter.
            self._rollback_to_flag = False
            rt.flag("canary_rollback")
        if path != "/stream":
            # Never mirror a stream packet: a shadow copy would open a
            # phantom session on the candidate and fork station state.
            self._maybe_mirror(path, body, status, payload, rt.trace_id)
        total_ms = rt.finish(status)
        headers = dict(headers)
        upstream_timing = headers.pop("Server-Timing", None)
        timing = f"router;dur={total_ms:.1f}"
        headers["Server-Timing"] = (
            f"{timing}, {upstream_timing}" if upstream_timing else timing
        )
        headers[obs_trace.TRACEPARENT_HEADER] = rt.traceparent
        return status, headers, payload

    def _forward_routed(
        self, path: str, body: bytes, rt: obs_trace.RequestTrace
    ) -> Tuple[int, Dict[str, str], bytes]:
        """The pick -> attempt -> classify -> retry/hedge loop."""
        self._bus.counter("router_requests", path=path.lstrip("/")).inc()
        deadline = time.monotonic() + self._budget_s(body)
        tried: Set[str] = set()
        attempts_left = 1 + max(0, int(self.config.retries))
        last: Optional[_Outcome] = None
        while attempts_left > 0 and time.monotonic() < deadline:
            replica = self._pick(tried, first_attempt=not tried)
            if replica is None and tried:
                # Every replica tried once; a retry may reuse one (the
                # failure could have been transient) as long as its
                # breaker still admits traffic.
                replica = self._pick(frozenset(), first_attempt=False)
            if replica is None:
                break
            attempts_left -= 1
            if tried:  # anything after the first attempt is a retry
                self._bus.counter("router_retries").inc()
                rt.flag("retried")
            tried.add(replica.url)
            if self.config.hedge_ms > 0:
                outcome, replica, attempts_left, pre_settled = (
                    self._attempt_hedged(
                        replica, path, body, deadline, tried,
                        attempts_left, rt,
                    )
                )
            else:
                outcome = self._attempt(replica, path, body, deadline,
                                        rt=rt)
                pre_settled = False
            if pre_settled:
                # The hedged path already fed this outcome to its
                # replica's breaker; settling again would double-count.
                _, retryable = _classify(outcome)
            else:
                _, retryable = self._settle(replica, outcome)
            if not retryable:
                if (
                    outcome.status == 503
                    and outcome.error_code() == "shed"
                ):
                    # A relayed shed verdict is deliberate policy, not a
                    # router failure — its own retention flag.
                    rt.flag("shed")
                return self._relay(outcome)
            last = outcome
        if last is not None:
            return self._relay(last)
        self._bus.counter("router_no_replica").inc()
        rt.annotate(no_replica=True)
        return (
            503,
            {},
            json.dumps(
                {"error": "no_replica",
                 "message": "no routable replica in the registry"}
            ).encode(),
        )

    # --------------------------------------------------- stream affinity
    # Routing heuristic only (the replica re-validates): pull station.id
    # out of the raw packet without JSON-decoding the waveform body —
    # same contract as _budget_s. The station object is flat (protocol
    # parse_station fields), so a brace-free inner match suffices.
    _STATION_OBJ_RE = re.compile(rb'"station"\s*:\s*\{([^{}]*)\}')
    _STATION_ID_RE = re.compile(rb'"id"\s*:\s*"((?:[^"\\]|\\.)*)"')

    @classmethod
    def _station_id(cls, body: bytes) -> Optional[str]:
        m = cls._STATION_OBJ_RE.search(body)
        if m is None:
            return None
        m2 = cls._STATION_ID_RE.search(m.group(1))
        if m2 is None:
            return None
        try:
            # json.loads on the quoted token resolves \-escapes exactly
            # the way the replica's real parser will.
            sid = json.loads((b'"' + m2.group(1) + b'"').decode())
        except (ValueError, UnicodeDecodeError):
            return None
        return str(sid) or None

    def _pick_station(
        self, station_id: str, tried: Set[str]
    ) -> Optional[Replica]:
        """Rendezvous pick: the station's highest-ranked routable
        replica whose breaker admits the request. ``allow()`` is asked
        in rank order only until one admits (it may consume the single
        half-open probe slot, so never poll it speculatively). Canary
        cohorts are deliberately ignored — a session cannot be split
        across versions mid-record."""
        replicas = {
            r.url: r
            for r in self.registry.replicas()
            if r.probe_ready and r.url not in tried
        }
        for url in self.affinity.rank(station_id, replicas):
            if replicas[url].breaker.allow():
                return replicas[url]
        return None

    def _forward_stream(
        self, path: str, body: bytes, rt: obs_trace.RequestTrace
    ) -> Tuple[int, Dict[str, str], bytes]:
        """Affinity-routed /stream: pick by rendezvous hash, retry down
        the station's rank order (the failover re-home), never hedge."""
        self._bus.counter("router_requests", path="stream").inc()
        sid = self._station_id(body)
        if sid is None:
            # No parsable station id: fall back to the stateless loop —
            # the replica will answer 400 with the protocol's message.
            return self._forward_routed(path, body, rt)
        deadline = time.monotonic() + self._budget_s(body)
        tried: Set[str] = set()
        attempts_left = 1 + max(0, int(self.config.retries))
        last: Optional[_Outcome] = None
        while attempts_left > 0 and time.monotonic() < deadline:
            replica = self._pick_station(sid, tried)
            if replica is None and tried:
                replica = self._pick_station(sid, frozenset())
            if replica is None:
                break
            attempts_left -= 1
            if tried:
                self._bus.counter("router_retries").inc()
                rt.flag("retried")
            tried.add(replica.url)
            outcome = self._attempt(replica, path, body, deadline, rt=rt)
            _, retryable = self._settle(replica, outcome)
            if not retryable:
                if (
                    outcome.status == 503
                    and outcome.error_code() == "shed"
                ):
                    rt.flag("shed")
                if outcome.status < 500:
                    # This replica owns the station now (it answered the
                    # packet); a changed home is a re-home — the
                    # failover event the chaos lane gates on.
                    prev = self.affinity.note(sid, replica.url)
                    if prev is not None:
                        self._bus.counter("stream_rehome").inc()
                        rt.flag("rehomed")
                        rt.annotate(rehome_from=prev, station=sid)
                return self._relay(outcome)
            last = outcome
        if last is not None:
            return self._relay(last)
        self._bus.counter("router_no_replica").inc()
        rt.annotate(no_replica=True)
        return (
            503,
            {},
            json.dumps(
                {"error": "no_replica",
                 "message": "no routable replica in the registry"}
            ).encode(),
        )

    def _settle(
        self, replica: Replica, outcome: _Outcome
    ) -> Tuple[bool, bool]:
        """Feed breaker + counters + canary cohort stats; ->
        (breaker_failure, retryable). Every launched attempt settles
        exactly once (winners here, hedge losers via the drain thread),
        so the canary's cohort accounting can't double-count either."""
        failure, retryable = _classify(outcome)
        if failure:
            replica.breaker.record_failure()
        else:
            replica.breaker.record_success(outcome.latency_ms)
        replica.count(failure)
        self._observe_canary(replica, outcome, failure)
        return failure, retryable

    # ---------------------------------------------------- canary + shadow
    def _cohort_pred(
        self, cohort: str, version: int, model: Optional[str] = None
    ):
        """Registry pick predicate selecting one rollout cohort by the
        replicas' probed ``{model: version}`` maps — scoped to one model
        when the canary/shadow named one (multi-model pools: a bare
        version number would otherwise match any entry's version)."""

        def pred(versions: Dict[str, Any]) -> bool:
            is_candidate = serves_version(versions, version, model)
            return is_candidate if cohort == "candidate" else not is_candidate

        return pred

    def _pick(
        self, tried: Set[str], first_attempt: bool
    ) -> Optional[Replica]:
        """Cohort-aware replica pick: under an active canary, ``k%`` of
        first attempts go to the candidate-version cohort and ALL
        retries/hedges stay incumbent; after a rollback (and under
        shadow mode) the candidate cohort gets exactly 0% of primary
        traffic. If the selected cohort has no routable replica,
        availability beats canary fidelity: fall back to a version-blind
        pick (counted)."""
        version: Optional[int] = None
        model: Optional[str] = None
        cohort = self.canary.routing_cohort(first_attempt)
        if cohort is not None:
            version, model = self.canary.version, self.canary.model
        elif self.shadow.active:
            # Shadow serves every client request from the incumbent; the
            # candidate only ever sees mirrored copies.
            cohort, version = "incumbent", self.shadow.version
            model = self.shadow.model
        if cohort is None or version is None:
            return self.registry.pick(exclude=tried)
        replica = self.registry.pick(
            exclude=tried,
            versions_pred=self._cohort_pred(cohort, version, model),
        )
        if replica is None:
            self._bus.counter("router_canary_fallback", cohort=cohort).inc()
            replica = self.registry.pick(exclude=tried)
        return replica

    def _observe_canary(
        self, replica: Replica, outcome: _Outcome, failure: bool
    ) -> None:
        """Feed one settled attempt to the canary's cohort stats; on a
        tripped budget, drain the canary (0%) and publish the rollback
        everywhere: log, bus counter, and (via the one-shot flag) the
        next forwarded request's trace."""
        if self.canary.state != "active":
            return
        cohort = self.canary.cohort_of(replica.versions)
        self._bus.counter("router_canary_requests", cohort=cohort).inc()
        if failure:
            self._bus.counter("router_canary_errors", cohort=cohort).inc()
        latency = None if failure else outcome.latency_ms
        reason = self.canary.observe(cohort, failure, latency)
        if reason:
            self._bus.counter(
                "router_canary_rollback",
                version=str(self.canary.version),
            ).inc()
            self._rollback_to_flag = True
            logger.warning(f"[router] CANARY ROLLBACK: {reason}")

    def _maybe_mirror(
        self, path: str, body: bytes, status: int, payload: bytes,
        trace_id: str,
    ) -> None:
        """Shadow mode: mirror this (sampled, successful, /predict)
        request to a candidate-cohort replica on a background thread and
        diff the decisions into the JSONL report. The client's response
        is already on the wire — mirroring costs it nothing."""
        if (
            path != "/predict"
            or status != 200
            or not self.shadow.active
            or not self.shadow.should_mirror(trace_id)
        ):
            return
        version = self.shadow.version
        if version is None:
            return
        replica = self.registry.pick(
            versions_pred=self._cohort_pred(
                "candidate", version, self.shadow.model
            )
        )
        if replica is None:
            self.shadow.record(
                trace_id, "no_candidate",
                {"reason": "no routable candidate replica"},
            )
            return
        if not self._mirror_slots.acquire(blocking=False):
            # All mirror slots busy (slow candidate): drop this mirror
            # rather than grow an unbounded thread pile — shadow is
            # sampling, a dropped sample is accounted, not a failure.
            self.shadow.record(trace_id, "skipped_busy")
            return
        threading.Thread(
            target=self._mirror_one,
            args=(replica, path, body, payload, trace_id),
            daemon=True,
            name="router-shadow",
        ).start()

    def _mirror_one(
        self, replica: Replica, path: str, body: bytes,
        primary_payload: bytes, trace_id: str,
    ) -> None:
        # Mirrors are breaker-neutral: shadow is observation, and a sick
        # candidate must surface in the report, not destabilize routing.
        # The try covers everything — a mirror thread must never die
        # loudly into a client-visible path (threadlint
        # thread-target-raises) and must always return its mirror slot.
        try:
            status, _, mirrored = _http_request(
                replica.url, "POST", path, body=body,
                timeout_s=self.config.request_timeout_s,
            )
            if status != 200:
                self.shadow.record(
                    trace_id, "mirror_errors",
                    {"replica": replica.url, "candidate_status": status},
                )
                self._bus.counter(
                    "router_shadow_mirrors", verdict="error"
                ).inc()
                return
            diff = decision_diff(
                json.loads(primary_payload.decode()),
                json.loads(mirrored.decode()),
            )
            verdict = "match" if diff["match"] else "mismatch"
            self.shadow.record(
                trace_id, verdict, {"replica": replica.url, "diff": diff}
            )
            self._bus.counter(
                "router_shadow_mirrors", verdict=verdict
            ).inc()
        except Exception as e:  # noqa: BLE001 — observation-only thread
            self.shadow.record(trace_id, "mirror_errors",
                               {"error": repr(e)})
            self._bus.counter(
                "router_shadow_mirrors", verdict="error"
            ).inc()
        finally:
            self._mirror_slots.release()

    def _relay(self, outcome: _Outcome) -> Tuple[int, Dict[str, str], bytes]:
        if outcome.is_net_error:
            # No HTTP response to relay: surface the failure class. A
            # timeout maps to 504 (the client's wait was consumed), a
            # refused/reset connection to 502.
            status = 504 if "timeout" in outcome.error else 502
            body = json.dumps(
                {"error": "replica_unreachable", "message": outcome.error}
            ).encode()
            self._bus.counter("router_responses", status=status).inc()
            return status, {}, body
        self._bus.counter("router_responses", status=outcome.status).inc()
        return outcome.status, outcome.headers, outcome.body

    def _attempt(
        self,
        replica: Replica,
        path: str,
        body: bytes,
        deadline: float,
        rt: Optional[obs_trace.RequestTrace] = None,
        hedge: bool = False,
    ) -> _Outcome:
        timeout_s = min(
            self.config.request_timeout_s,
            max(0.05, deadline - time.monotonic()),
        )
        # The attempt's span id is minted BEFORE the request so the
        # downstream replica's server span can parent to it — the header
        # carries (trace_id, attempt_span_id); the span itself is
        # recorded once the outcome is known.
        span_id: Optional[str] = None
        headers: Optional[Dict[str, str]] = None
        breaker_state = replica.breaker.state
        if rt is not None:
            span_id = obs_trace._new_span_id()
            headers = {
                obs_trace.TRACEPARENT_HEADER: obs_trace.format_traceparent(
                    rt.trace_id, span_id
                )
            }
        t0 = time.monotonic()
        try:
            status, resp_headers, payload = _http_request(
                replica.url, "POST", path, body=body, timeout_s=timeout_s,
                headers=headers,
            )
            outcome = _Outcome(
                status,
                resp_headers,
                payload,
                latency_ms=(time.monotonic() - t0) * 1e3,
            )
        except socket.timeout:
            outcome = _Outcome(0, {}, b"", error="timeout")
        except (OSError, http.client.HTTPException) as e:
            # RemoteDisconnected/BadStatusLine are HTTPException (a
            # SIGKILLed replica's half-written response), the rest OSError.
            msg = f"{type(e).__name__}: {e}"
            if "timed out" in str(e):
                msg = f"timeout ({msg})"
            outcome = _Outcome(0, {}, b"", error=msg)
        if rt is not None:
            ann: Dict[str, Any] = {
                "replica": replica.url,
                "breaker": breaker_state,
                "class": _classify_label(outcome),
            }
            if hedge:
                ann["hedge"] = True
            if outcome.is_net_error:
                ann["error"] = outcome.error
            else:
                ann["status"] = outcome.status
            rt.add_child(
                "attempt", (time.monotonic() - t0) * 1e3,
                span_id=span_id, **ann,
            )
        return outcome

    def _attempt_hedged(
        self,
        primary: Replica,
        path: str,
        body: bytes,
        deadline: float,
        tried: Set[str],
        attempts_left: int,
        rt: Optional[obs_trace.RequestTrace] = None,
    ) -> Tuple[_Outcome, Replica, int, bool]:
        """Race the primary against a late-started hedge on another
        replica; first non-retryable outcome wins. The hedge consumes one
        unit of the retry budget (a hedge IS a speculative retry). Every
        launched attempt settles its breaker exactly once — losers and
        stragglers via a background drain, so a black-holed loser keeps
        counting. Returns ``(outcome, replica, attempts_left,
        pre_settled)``: when ``pre_settled`` the outcome was already fed
        to its breaker here and the caller must not settle it again."""
        results: "Queue[Tuple[_Outcome, Replica]]" = Queue()

        def run(replica: Replica, hedge: bool = False) -> None:
            # The waiter blocks on `results`: an attempt thread dying
            # without putting would stall the race to the full deadline,
            # so any surprise becomes a poisoned net-error outcome
            # (threadlint thread-target-raises).
            try:
                results.put((
                    self._attempt(replica, path, body, deadline, rt=rt,
                                  hedge=hedge),
                    replica,
                ))
            except BaseException as e:  # noqa: BLE001
                results.put((
                    _Outcome(0, {}, b"", error=f"attempt crashed: {e!r}"),
                    replica,
                ))

        threading.Thread(
            target=run, args=(primary,), daemon=True,
            name="router-attempt",
        ).start()
        launched = [primary]
        try:
            outcome, winner = results.get(
                timeout=self.config.hedge_ms / 1000.0
            )
            return outcome, winner, attempts_left, False
        except Empty:
            pass
        # A hedge is a speculative retry: under a canary it stays on the
        # incumbent cohort like every other retry (first_attempt=False).
        hedge = (
            self._pick(tried, first_attempt=False)
            if attempts_left > 0 else None
        )
        if hedge is not None:
            attempts_left -= 1
            tried.add(hedge.url)
            self._bus.counter("router_hedges").inc()
            if rt is not None:
                rt.flag("hedged")
            threading.Thread(
                target=run, args=(hedge, True), daemon=True,
                name="router-hedge",
            ).start()
            launched.append(hedge)

        def drain_pending(seen_n: int) -> None:
            if seen_n < len(launched):
                threading.Thread(
                    target=self._drain_loser,
                    args=(results, len(launched) - seen_n),
                    daemon=True,
                    name="router-hedge-drain",
                ).start()

        seen = 0
        best: Optional[Tuple[_Outcome, Replica]] = None
        while seen < len(launched):
            remaining = max(0.05, deadline - time.monotonic())
            try:
                outcome, replica = results.get(timeout=remaining)
            except Empty:
                break
            seen += 1
            _, retryable = _classify(outcome)
            if not retryable:
                # Acceptable answer: forward() settles the winner; the
                # straggler is accounted when it eventually lands.
                drain_pending(seen)
                return outcome, replica, attempts_left, False
            # Failed retryably: settle its breaker now and keep waiting
            # for the other attempt (if any).
            self._settle(replica, outcome)
            best = (outcome, replica)
        # Deadline ran out. Whatever came back was settled above
        # (pre_settled=True keeps forward() from double-counting it);
        # whatever is still in flight settles via the drain.
        drain_pending(seen)
        if best is not None:
            return best[0], best[1], attempts_left, True
        # Neither attempt returned before the deadline: synthesize a
        # timeout for relay. The real outcomes settle via the drain, so
        # the synthetic one must not touch any breaker.
        return (
            _Outcome(0, {}, b"", error="timeout"),
            primary,
            attempts_left,
            True,
        )

    def _drain_loser(self, results: Queue, n: int) -> None:
        # Best-effort breaker accounting for hedge losers; a surprise here
        # must not die silently mid-drain (threadlint
        # thread-target-raises) — log it, the breaker just misses one
        # sample.
        try:
            for _ in range(n):
                try:
                    outcome, replica = results.get(
                        timeout=self.config.request_timeout_s + 1.0
                    )
                except Empty:
                    return
                self._settle(replica, outcome)
        except Exception as e:  # noqa: BLE001 — accounting-only thread
            logger.warning(f"[router] hedge drain failed: {e!r}")

    _TIMEOUT_MS_RE = re.compile(rb'"timeout_ms"\s*:\s*([0-9eE.+-]+)')

    def _budget_s(self, body: bytes) -> float:
        """Total routing budget: the client's own options.timeout_ms plus
        slack when findable, else enough for every attempt to time out.
        This is a routing heuristic, not protocol validation (the replica
        re-validates), so a regex scan suffices at every size: the front
        tier must not decode a waveform payload (a 256-sample /predict is
        already ~20 KB, hours-long /annotate records run to tens of MB)
        just to read one scalar, and the quoted key cannot appear inside
        the numeric arrays."""
        fallback = self.config.request_timeout_s * (
            1 + max(0, int(self.config.retries))
        )
        m = self._TIMEOUT_MS_RE.search(body)
        try:
            timeout_ms = float(m.group(1)) if m else 0.0
        except ValueError:
            return fallback
        if timeout_ms <= 0:
            return fallback
        return timeout_ms / 1000.0 + 0.5

    # ------------------------------------------------------------- metrics
    _CANARY_STATE_CODES = {"inactive": 0, "active": 1, "rolled_back": 2}

    def _collect(self) -> Dict[str, Any]:
        replicas = self.registry.snapshot()
        affinity = self.affinity.snapshot()
        return {
            "replicas": len(replicas),
            "replicas_ready": sum(1 for r in replicas if r["ready"]),
            "stream_stations": affinity["stations"],
            "stream_rehomes": affinity["rehomes"],
            "breakers_open": sum(
                1 for r in replicas if r["breaker"]["state"] != CLOSED
            ),
            "canary_percent": self.canary.percent,
            "canary_state_code": self._CANARY_STATE_CODES.get(
                self.canary.state, 0
            ),
        }

    def status(self) -> Dict[str, Any]:
        return {
            "replicas": self.registry.snapshot(),
            "ready": self.registry.ready_count(),
            "stream": self.affinity.snapshot(),
            "canary": self.canary.status(),
            "shadow": self.shadow.status(),
            "config": {
                "retries": self.config.retries,
                "hedge_ms": self.config.hedge_ms,
                "request_timeout_s": self.config.request_timeout_s,
            },
        }


# ----------------------------------------------------------- http plumbing
def _http_request(
    base_url: str,
    method: str,
    path: str,
    body: Optional[bytes] = None,
    timeout_s: float = 10.0,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, Dict[str, str], bytes]:
    """One HTTP exchange against ``base_url`` (``host:port`` or
    ``http://host:port``); returns (status, headers, body). Raises
    OSError subclasses (incl. socket.timeout) on network failure.
    ``headers`` adds request headers (trace propagation)."""
    hostport = base_url.split("://", 1)[-1].rstrip("/")
    conn = http.client.HTTPConnection(hostport, timeout=timeout_s)
    try:
        send_headers = {"Content-Type": "application/json"} if body else {}
        send_headers.update(headers or {})
        conn.request(method, path, body=body, headers=send_headers)
        resp = conn.getresponse()
        payload = resp.read()
        keep = {}
        # Server-Timing/traceparent relay the replica's breakdown + trace
        # identity through the router to the client.
        for k in ("Content-Type", "Retry-After", "Server-Timing",
                  "traceparent"):
            v = resp.getheader(k)
            if v is not None:
                keep[k] = v
        return resp.status, keep, payload
    finally:
        conn.close()


# ----------------------------------------------------------------- HTTP shim
MAX_BODY_BYTES = 64 * 1024 * 1024  # match serve/server.py


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "seist-router/0.1"
    protocol_version = "HTTP/1.1"

    @property
    def router(self) -> Router:
        return self.server.router  # type: ignore[attr-defined]

    def log_message(self, format: str, *args: Any) -> None:
        logger.debug(f"[router] {self.address_string()} {format % args}")

    def _reply(
        self,
        status: int,
        body: bytes,
        ctype: str = "application/json",
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            if k.lower() != "content-type":
                self.send_header(k, v)
        if self.close_connection:
            # Tell the client, not just the socket: without the header an
            # HTTP/1.1 client assumes keep-alive and retries a dead conn
            # (same contract as serve/server.py's _reply).
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, status: int, payload: Any) -> None:
        self._reply(status, json.dumps(payload).encode())

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        try:
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                ready = self.router.registry.ready_count()
                self._reply_json(
                    200 if ready else 503,
                    {"status": "ok" if ready else "no_replicas",
                     "ready_replicas": ready},
                )
            elif path == "/router/replicas":
                self._reply_json(200, self.router.status())
            elif path == "/router/canary":
                self._reply_json(200, self.router.canary.status())
            elif path == "/router/shadow":
                self._reply_json(200, self.router.shadow.status())
            elif path == "/metrics":
                from seist_tpu_torch.obs.bus import render_prometheus

                self._reply(
                    200,
                    render_prometheus(self.router._bus).encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/metrics.json":
                self._reply_json(200, self.router._bus.snapshot())
            elif path.startswith("/traces"):
                routed = obs_trace.handle_traces_path(self.path)
                if routed is None:
                    self._reply_json(404, {"error": "not_found",
                                           "message": self.path})
                else:
                    self._reply_json(*routed)
            elif path in ("/fleet/metrics", "/fleet/metrics.json"):
                # Fleet aggregation pane (obs/fleet.py), attached by the
                # fleet supervisor; a bare router has no fleet view.
                fleet = getattr(self.server, "fleet", None)
                if fleet is None:
                    self._reply_json(
                        404,
                        {"error": "no_fleet",
                         "message": "no fleet aggregator attached "
                         "(run under python -m seist_tpu_torch supervise-fleet)"},
                    )
                elif path == "/fleet/metrics.json":
                    self._reply_json(200, fleet.merged())
                else:
                    self._reply(
                        200,
                        fleet.render_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
            else:
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})
        except Exception as e:  # noqa: BLE001 — a handler bug must 500,
            # not kill the connection thread mid-response
            self._reply_json(500, {"error": "internal", "message": repr(e)})

    def do_POST(self) -> None:  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_BODY_BYTES:
                self.close_connection = True
                self._reply_json(
                    413,
                    {"error": "too_large",
                     "message": f"body {length} > {MAX_BODY_BYTES} bytes"},
                )
                return
            body = self.rfile.read(length)
            path = self.path.split("?", 1)[0]
            if path in ("/predict", "/annotate", "/stream"):
                status, headers, payload = self.router.forward(
                    path, body,
                    traceparent=self.headers.get(
                        obs_trace.TRACEPARENT_HEADER
                    ),
                )
                self._reply(status, payload, headers=headers)
            elif path == "/router/register":
                url = self._admin_url(body)
                if url:
                    self.router.registry.add(url)
                    self._reply_json(200, {"registered": url})
            elif path == "/router/deregister":
                url = self._admin_url(body)
                if url:
                    removed = self.router.registry.remove(url)
                    self._reply_json(
                        200 if removed else 404, {"deregistered": removed}
                    )
            elif path == "/router/canary":
                # {"version": V, "percent": k, "max_error_delta"?,
                #  "max_latency_delta_ms"?, "min_requests"?};
                # percent 0 (or missing version) clears the canary.
                self._admin_canary(body)
            elif path == "/router/shadow":
                # {"version": V, "sample": 0.1, "report"?: path};
                # sample 0 (or missing version) clears shadow mode.
                self._admin_shadow(body)
            else:
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})
        except Exception as e:  # noqa: BLE001 — same contract as do_GET
            logger.warning(f"[router] unhandled error: {e!r}")
            self._reply_json(500, {"error": "internal", "message": repr(e)})

    def _admin_canary(self, body: bytes) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            spec = None
        if not isinstance(spec, dict):
            self._reply_json(400, {"error": "bad_request",
                                   "message": "body must be a JSON object"})
            return
        try:
            percent = float(spec.get("percent", 0) or 0)
            if percent <= 0 or spec.get("version") is None:
                self._reply_json(200, self.router.canary.stop())
                return
            budget = CanaryBudget(
                max_error_delta=float(
                    spec.get("max_error_delta",
                             CanaryBudget.max_error_delta)
                ),
                max_latency_delta_ms=float(
                    spec.get("max_latency_delta_ms",
                             CanaryBudget.max_latency_delta_ms)
                ),
                min_requests=int(
                    spec.get("min_requests", CanaryBudget.min_requests)
                ),
            )
            self._reply_json(
                200,
                self.router.canary.start(
                    int(spec["version"]), percent, budget,
                    model=str(spec["model"]) if spec.get("model") else None,
                ),
            )
        except (TypeError, ValueError) as e:
            self._reply_json(400, {"error": "bad_request",
                                   "message": str(e)})

    def _admin_shadow(self, body: bytes) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            spec = None
        if not isinstance(spec, dict):
            self._reply_json(400, {"error": "bad_request",
                                   "message": "body must be a JSON object"})
            return
        try:
            sample = float(spec.get("sample", 0) or 0)
            if sample <= 0 or spec.get("version") is None:
                self._reply_json(200, self.router.shadow.stop())
                return
            self._reply_json(
                200,
                self.router.shadow.start(
                    int(spec["version"]), sample,
                    str(spec.get("report", "") or ""),
                    model=str(spec["model"]) if spec.get("model") else None,
                ),
            )
        except (TypeError, ValueError) as e:
            self._reply_json(400, {"error": "bad_request",
                                   "message": str(e)})

    def _admin_url(self, body: bytes) -> Optional[str]:
        try:
            url = json.loads(body.decode()).get("url", "")
        except (ValueError, UnicodeDecodeError, AttributeError):
            url = ""
        if not isinstance(url, str) or not url:
            self._reply_json(400, {"error": "bad_request",
                                   "message": "body must be {'url': ...}"})
            return None
        return url


class RouterHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default listen backlog is 5: under an open-loop
    # connection burst (every bench/ops client opens a conn per request)
    # SYNs overflow the backlog and get silently dropped, and the client
    # kernel retries at 1/3/7/15/31 s — which shows up as latency
    # *clusters* at exactly those values while the service itself is
    # idle. A front tier must absorb accept bursts; overload policy
    # belongs to the shed/429 tiers, not the kernel's SYN queue.
    request_queue_size = 1024

    #: obs/fleet.FleetAggregator when running under the fleet supervisor
    #: (serves /fleet/metrics); None on a bare router.
    fleet = None

    def __init__(self, addr: Tuple[str, int], router: Router):
        super().__init__(addr, _RouterHandler)
        self.router = router


def start_router_server(
    router: Router, host: str = "127.0.0.1", port: int = 8080
) -> RouterHTTPServer:
    """Bind + serve on a daemon thread (ephemeral port via ``port=0``);
    also starts the health prober."""
    server = RouterHTTPServer((host, port), router)
    thread = threading.Thread(
        target=server.serve_forever, name="router-http", daemon=True
    )
    thread.start()
    router.start_prober()
    return server


# ----------------------------------------------------------------- CLI
def get_router_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="router",
        description="seist_tpu_torch serving front tier: replica router",
    )
    ap.add_argument(
        "--replica", action="append", default=[], metavar="HOST:PORT",
        help="replica base address, repeatable (more can be registered "
        "at runtime via POST /router/register)",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--request-timeout-s", type=float, default=10.0)
    ap.add_argument("--hedge-ms", type=float, default=0.0)
    ap.add_argument("--probe-interval-s", type=float, default=1.0)
    ap.add_argument("--breaker-failures", type=int, default=3)
    ap.add_argument("--breaker-cooldown-s", type=float, default=2.0)
    ap.add_argument("--breaker-latency-trip-ms", type=float,
                    default=float("inf"))
    return ap.parse_args(argv)


def router_from_args(args: argparse.Namespace) -> Router:
    config = RouterConfig(
        retries=args.retries,
        request_timeout_s=args.request_timeout_s,
        hedge_ms=args.hedge_ms,
        probe_interval_s=args.probe_interval_s,
        breaker_failures=args.breaker_failures,
        breaker_cooldown_s=args.breaker_cooldown_s,
        breaker_latency_trip_ms=args.breaker_latency_trip_ms,
    )
    router = Router(config=config)
    for url in args.replica:
        router.registry.add(url)
    return router


def main(argv: Optional[List[str]] = None) -> None:
    args = get_router_args(argv)
    router = router_from_args(args)
    obs_trace.register_trace_collector()
    server = start_router_server(router, args.host, args.port)
    host, port = server.server_address[:2]
    logger.info(
        f"[router] listening on http://{host}:{port} "
        f"replicas={[r.url for r in router.registry.replicas()]}"
    )
    stop = threading.Event()
    import signal

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    # threadlint: disable=wait-no-timeout -- main thread parked until the
    # signal handler (the only setter) fires; CPython wakes an untimed
    # main-thread Event.wait to run handlers, so no wakeup can be lost.
    stop.wait()
    server.shutdown()
    router.stop()
    logger.info("[router] stopped")


if __name__ == "__main__":
    main()
