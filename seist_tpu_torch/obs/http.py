"""Opt-in metrics HTTP endpoint of the train worker (``--metrics-port``;
the port's copy of ``seist_tpu/obs/http.py``).

Prometheus scrapes ``/metrics``, an operator reads ``/metrics.json`` or
``/flight``, and ``POST /profile`` asks the train loop for a
``torch.profiler`` capture window (the machinery of ``--profile-steps``
and SIGUSR2: the loop polls the trigger between steps, so a capture starts
on a step edge and never during a graph capture).

Endpoints::

    GET  /metrics        Prometheus text exposition (bus + collectors)
    GET  /metrics.json   JSON snapshot of the bus
    GET  /flight         live flight-recorder ring (no file written)
    GET  /traces         request-trace index (obs/trace.py ring)
    GET  /traces/<id>    one trace's span segments (this process)
    POST /profile[?steps=N]  request a profiler capture (default 5 steps)
    GET  /healthz        {"status": "ok"} liveness

Standard library ``http.server`` on a daemon thread, bound to loopback by
default: the metrics are unauthenticated.
"""

from __future__ import annotations

import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from seist_tpu_torch.obs import bus as bus_mod
from seist_tpu_torch.obs import flight as flight_mod
from seist_tpu_torch.obs import trace as trace_mod
from seist_tpu_torch.obs.bus import MetricsBus, render_prometheus
from seist_tpu_torch.utils.logger import logger

DEFAULT_PROFILE_STEPS = 5


class ProfileTrigger:
    """Request box for an on-demand profiler capture. HTTP and SIGUSR2
    call :meth:`request`; the train loop calls :meth:`consume` at step
    boundaries and starts a capture when it returns > 0 (several pending
    requests coalesce into one capture, last-requested width wins).

    Deliberately lock-free:
    :meth:`request` runs inside the SIGUSR2 handler, which interrupts the
    main thread at an arbitrary bytecode boundary — if that thread were
    inside a locked :meth:`consume` at that moment, a lock here would
    self-deadlock the process. ``deque.append`` and ``deque.popleft``
    are each one GIL-atomic operation, so a request landing at any point
    during :meth:`consume` is either drained by it or sits intact for
    the next step-boundary poll — nothing is ever consumed-and-dropped
    (the maxlen bounds pathological signal storms; overflow discards
    oldest, and consume takes the newest anyway).
    """

    def __init__(self) -> None:
        self._requests: "deque[int]" = deque(maxlen=64)

    def request(self, steps: int = DEFAULT_PROFILE_STEPS) -> None:
        self._requests.append(max(1, int(steps)))

    def consume(self) -> int:
        if not self._requests:  # cheap per-step fast path
            return 0
        steps = 0
        while True:
            try:
                steps = self._requests.popleft()
            except IndexError:
                return steps


def _json_bytes(payload) -> bytes:
    import json

    return json.dumps(payload, default=str).encode()


class _Handler(BaseHTTPRequestHandler):
    server_version = "seist-obs/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args) -> None:
        logger.debug(f"[obs] {self.address_string()} {format % args}")

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @property
    def _bus(self) -> MetricsBus:
        return self.server.bus  # type: ignore[attr-defined]

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        try:
            parsed = urlparse(self.path)
            if parsed.path == "/metrics":
                self._reply(
                    200,
                    render_prometheus(self._bus).encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif parsed.path == "/metrics.json":
                self._reply(
                    200, _json_bytes(self._bus.snapshot()), "application/json"
                )
            elif parsed.path == "/flight":
                rec = flight_mod.get()
                if rec is None:
                    self._reply(
                        404,
                        _json_bytes({"error": "no flight recorder installed"}),
                        "application/json",
                    )
                else:
                    self._reply(
                        200,
                        _json_bytes(rec.payload("live")),
                        "application/json",
                    )
            elif parsed.path.startswith("/traces"):
                routed = trace_mod.handle_traces_path(self.path)
                if routed is None:
                    self._reply(
                        404, _json_bytes({"error": "not_found"}),
                        "application/json",
                    )
                else:
                    status, payload = routed
                    self._reply(
                        status, _json_bytes(payload), "application/json"
                    )
            elif parsed.path == "/healthz":
                self._reply(200, _json_bytes({"status": "ok"}), "application/json")
            else:
                self._reply(
                    404, _json_bytes({"error": "not_found"}), "application/json"
                )
        except Exception as e:  # noqa: BLE001 - a scrape bug must not kill
            # the handler thread (and 500 is the right scrape outcome)
            try:
                self._reply(500, _json_bytes({"error": repr(e)}), "application/json")
            except OSError:
                pass

    def do_POST(self) -> None:  # noqa: N802
        try:
            parsed = urlparse(self.path)
            # Drain any body so keep-alive connections stay in sync.
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                self.rfile.read(min(length, 1 << 16))
            if parsed.path == "/profile":
                trigger = self.server.profile_trigger  # type: ignore[attr-defined]
                if trigger is None:
                    self._reply(
                        404,
                        _json_bytes(
                            {"error": "no profile trigger (not a train run?)"}
                        ),
                        "application/json",
                    )
                    return
                q = parse_qs(parsed.query)
                steps = int(q.get("steps", [DEFAULT_PROFILE_STEPS])[0])
                trigger.request(steps)
                self._reply(
                    200,
                    _json_bytes({"requested_steps": max(1, steps)}),
                    "application/json",
                )
            else:
                self._reply(
                    404, _json_bytes({"error": "not_found"}), "application/json"
                )
        except Exception as e:  # noqa: BLE001 - same contract as do_GET
            try:
                self._reply(500, _json_bytes({"error": repr(e)}), "application/json")
            except OSError:
                pass


class MetricsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's backlog-5 default drops SYNs when a dashboard, an
    # operator's curl and Prometheus collide (as in ServeHTTPServer).
    request_queue_size = 1024

    def __init__(
        self,
        addr: Tuple[str, int],
        bus: MetricsBus,
        profile_trigger: Optional[ProfileTrigger] = None,
    ):
        super().__init__(addr, _Handler)
        self.bus = bus
        self.profile_trigger = profile_trigger


def start_metrics_server(
    port: int,
    bus: Optional[MetricsBus] = None,
    profile_trigger: Optional[ProfileTrigger] = None,
    host: str = "127.0.0.1",
) -> MetricsHTTPServer:
    """Bind + serve on a daemon thread; ``port`` 0 or -1 binds an
    ephemeral port (read it back from ``server.server_address``). The bound
    port is logged so an operator can find it in the run log."""
    server = MetricsHTTPServer(
        (host, max(int(port), 0)), bus if bus is not None else bus_mod.BUS,
        profile_trigger,
    )
    thread = threading.Thread(
        target=server.serve_forever, name="obs-metrics-http", daemon=True
    )
    thread.start()
    bound = server.server_address[1]
    logger.info(f"[obs] metrics endpoint: http://{host}:{bound}/metrics")
    return server
