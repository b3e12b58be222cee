"""Online inference service of the port: ``POST /predict``,
``GET /healthz``, ``GET /metrics``.

Counterpart of ``seist_tpu/serve/server.py``'s single-model path. Each
``/predict`` parses one trace, normalizes it, pads it to the model's
window and waits on the model's micro-batcher; the batcher's worker runs
the forward on the device, and the handler thread decodes its own row
(peak picking / event detection) into JSON. ``/metrics`` reports the
request count, forwards, batch fill, latency percentiles and the launches
of the attention kernel. SIGTERM drains: queued requests are served,
new ones get 503, and the process exits 0.

    python -m seist_tpu_torch serve --model seist_l_dpk[=WEIGHTS.pt] --window 8192
"""

from __future__ import annotations

import argparse
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from seist_tpu_torch.data.preprocess import NORM_MODES, normalize
from seist_tpu_torch.ops import pooled_attention
from seist_tpu_torch.serve.batcher import BatcherConfig, MicroBatcher, default_buckets
from seist_tpu_torch.serve.pool import (
    ModelEntry,
    clip_picks,
    decode_outputs,
    get_entry,
    load_model_entry,
)
from seist_tpu_torch.serve.protocol import (
    BadRequest,
    PredictOptions,
    ServeError,
    ShuttingDown,
    json_bytes,
    parse_body,
    parse_waveform,
)
from seist_tpu_torch.utils.logger import logger

MAX_BODY_BYTES = 64 * 1024 * 1024


class ServeService:
    """Transport-free serving core: every public method raises ServeError
    subclasses on failure and returns JSON-able dicts on success. The
    entries are warmed up (every bucket once) before the service exists."""

    def __init__(self, entries: Sequence[ModelEntry], config: BatcherConfig):
        self.entries: Dict[str, ModelEntry] = {e.name: e for e in entries}
        self.config = config
        self.buckets = default_buckets(config.max_batch)
        self.warmup = [r for e in entries for r in e.warmup(self.buckets)]
        self._batchers = {
            name: MicroBatcher(e.run, config, name=name) for name, e in self.entries.items()
        }
        self._lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._draining = False
        self._started = time.monotonic()

    def predict(
        self, data: Any, model: Optional[str] = None, options: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """One fixed-window trace through the micro-batcher."""
        with self._lock:
            self._requests += 1
        try:
            return self._predict(data, model, options)
        except ServeError:
            with self._lock:
                self._errors += 1
            raise

    def _predict(self, data: Any, model: Optional[str], options: Optional[Dict[str, Any]]):
        if self._draining:
            raise ShuttingDown("service is draining")
        entry = get_entry(self.entries, model)
        opts = PredictOptions.from_dict(options)
        if opts.norm_mode not in NORM_MODES:
            raise BadRequest(f"norm_mode must be one of {NORM_MODES}, got '{opts.norm_mode}'")
        x = parse_waveform(data, entry.in_channels)
        if x.shape[0] > entry.window:
            raise BadRequest(f"trace length {x.shape[0]} > window {entry.window}")
        x = np.asarray(normalize(x, opts.norm_mode, axis=0), np.float32)
        n_real = x.shape[0]
        if n_real < entry.window:  # pad AFTER normalize: zeros stay 0
            x = np.concatenate(
                [x, np.zeros((entry.window - n_real, x.shape[1]), np.float32)]
            )
        raw = self._batchers[entry.name].submit(x, timeout_ms=opts.timeout_ms)
        result = decode_outputs(entry, raw, opts)
        if n_real < entry.window:
            # The signal->zeros step at the padding boundary can fabricate
            # picks inside samples the client never sent.
            clip_picks(result, n_real, float(opts.sampling_rate))
        result["model"] = entry.name
        return result

    def healthz(self) -> Dict[str, Any]:
        return {
            "status": "draining" if self._draining else "ok",
            "models": sorted(self.entries),
            "devices": {n: str(e.device) for n, e in self.entries.items()},
            "window": {n: e.window for n, e in self.entries.items()},
            "buckets": list(self.buckets),
            "healthy": self.alive(),
        }

    def alive(self) -> bool:
        return all(b.healthy for b in self._batchers.values())

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            requests, errors = self._requests, self._errors
        return {
            "uptime_s": round(time.monotonic() - self._started, 3),
            "requests": requests,
            "errors": errors,
            "models": {n: b.stats() for n, b in self._batchers.items()},
            "kernels": {"pooled_attention_fwd": {"launches": pooled_attention.launches}},
            "warmup": self.warmup,
        }

    def begin_drain(self) -> None:
        self._draining = True

    def shutdown(self, drain: bool = True) -> None:
        self.begin_drain()
        for b in self._batchers.values():
            b.shutdown(drain=drain)


class _Handler(BaseHTTPRequestHandler):
    server_version = "seist-torch-serve/0.1"
    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> ServeService:
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, format: str, *args: Any) -> None:
        logger.debug(f"[serve] {self.address_string()} {format % args}")

    def _reply(self, status: int, payload: Dict[str, Any]) -> None:
        body = json_bytes(payload)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._reply(200, self.service.healthz())
        elif path == "/metrics":
            self._reply(200, self.service.metrics())
        else:
            self._reply(404, {"error": "not_found", "message": self.path})

    def do_POST(self) -> None:  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_BODY_BYTES:
                # The unread body would desync this keep-alive connection.
                self.close_connection = True
                self._reply(413, {"error": "too_large",
                                  "message": f"body {length} > {MAX_BODY_BYTES} bytes"})
                return
            raw = self.rfile.read(length)
            if self.path != "/predict":
                self._reply(404, {"error": "not_found", "message": self.path})
                return
            body = parse_body(raw)
            result = self.service.predict(
                body.get("data"), model=body.get("model"), options=body.get("options")
            )
            self._reply(200, result)
        except ServeError as e:
            self._reply(e.status, e.payload())
        except Exception as e:  # noqa: BLE001 — a handler bug answers 500, the server lives
            logger.exception(f"[serve] unhandled error: {e!r}")
            self._reply(500, {"error": "internal", "message": repr(e)})


class ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # The default listen backlog of 5 drops SYNs under a burst of
    # connection-per-request clients (retried after 1/3/7 s).
    request_queue_size = 1024

    def __init__(self, addr: Tuple[str, int], service: ServeService):
        super().__init__(addr, _Handler)
        self.service = service


def start_http_server(
    service: ServeService, host: str = "127.0.0.1", port: int = 8080
) -> ServeHTTPServer:
    """Bind and serve on a daemon thread; returns the bound server (use
    ``server.server_address`` to discover an ephemeral port)."""
    server = ServeHTTPServer((host, port), service)
    threading.Thread(target=server.serve_forever, name="serve-http", daemon=True).start()
    return server


def build_service(
    models: Sequence[Tuple[str, str]],
    *,
    window: int = 8192,
    device: str = "cuda",
    max_batch: int = 8,
    max_delay_ms: float = 10.0,
) -> ServeService:
    """Load ``(name, weights)`` entries on ``device`` and warm them up."""
    entries = [
        load_model_entry(name, weights, window=window, device=device)
        for name, weights in models
    ]
    return ServeService(entries, BatcherConfig(max_batch=max_batch, max_delay_ms=max_delay_ms))


def get_serve_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="serve", description="seist_tpu_torch online inference service"
    )
    ap.add_argument(
        "--model", action="append", default=[], metavar="NAME[=WEIGHTS]",
        help="model to serve, repeatable; NAME alone serves seeded random "
        "weights (smoke/testing); WEIGHTS is a .pt state_dict "
        "(models/convert.py::save_torch_weights)",
    )
    ap.add_argument("--window", type=int, default=8192)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=10.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.model:
        ap.error("need --model NAME[=WEIGHTS]")
    return args


def main(argv: Optional[List[str]] = None) -> None:
    import signal

    args = get_serve_args(argv)
    service = build_service(
        [tuple(spec.partition("=")[::2]) for spec in args.model],
        window=args.window,
        device=args.device,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
    )
    server = start_http_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    logger.info(
        f"[serve] listening on http://{host}:{port} models={sorted(service.entries)} "
        f"buckets={list(service.buckets)} device={args.device}"
    )
    stop = threading.Event()

    def _term(signum, frame):
        service.begin_drain()
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    rc = 0
    while not stop.wait(0.5):
        if not service.alive():
            logger.warning("[serve] a batcher worker died; exiting 1")
            rc = 1
            break
    logger.info("[serve] draining...")
    service.shutdown(drain=rc == 0)
    server.shutdown()
    logger.info(f"[serve] stopped (rc={rc})")
    if rc:
        raise SystemExit(rc)
