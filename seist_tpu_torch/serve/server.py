"""Online inference service of the port: ``POST /predict``,
``POST /admin/reload``, ``GET /healthz``, ``GET /metrics``,
``GET /metrics.json``, ``GET /traces[/<id>]``.

Counterpart of ``seist_tpu/serve/server.py``. Each ``/predict`` parses one
trace, normalizes it, pads it to the model's window and waits on the
micro-batcher of its (model, variant); the batcher's worker replays the
bucket's captured program (``serve/aot.py``), and the handler thread
decodes its own row (peak picking / event detection, or each requested
head of a task group) into JSON. Every response carries the
``model_version`` that answered it. ``POST /admin/reload`` hot-swaps one
entry for a new checkpoint behind the gate ladder of
``serve/pool.py::ModelPool.reload``, one reload at a time; the incumbent
serves throughout. ``/metrics`` reports requests, forwards, batch fill,
latency percentiles, the attention kernel's launches, the programs'
capture seconds and memory, ``graph_captures`` and ``fallback_runs``, and
each group's fan-out (trunk runs, head runs, trunk FLOPs saved; served
traffic only); ``/metrics?format=prometheus`` is the metrics bus in
Prometheus text (``obs/bus.py``), ``/metrics.json`` its JSON snapshot.
SIGTERM drains: queued requests are served, new ones get 503, and the
process exits 0.

Tracing (``obs/trace.py``): every ``/predict`` continues the request's
``traceparent`` or mints one, and records the spans ``parse``,
``normalize``, ``queue_wait``, ``forward`` and ``decode``; every reply to
it, errors included, carries ``Server-Timing`` (``total`` and each span)
and the ``traceparent`` echo, and ``GET /traces/<trace id>`` returns the
spans. ``serve`` also writes ``events<replica>.jsonl`` and installs a
flight recorder in its log directory (``./logs``), dumped when a batcher
thread dies or a handler raises.

    python -m seist_tpu_torch serve --model seist_l_dpk[=WEIGHTS.pt] --window 8192 \\
        [--model-group seist_l=dpk,emg:W.pt,dis] [--variants fp32,bf16,int8]

``SEIST_FAULT_SERVE_BAD_CANDIDATE=<version>`` makes that model version
bad: a reload to it fails its gate, and an entry serving it answers every
``/predict`` with a 500.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from seist_tpu_torch.data.preprocess import NORM_MODES, normalize
from seist_tpu_torch.obs import flight as obs_flight
from seist_tpu_torch.obs import trace as obs_trace
from seist_tpu_torch.obs.bus import BUS, EventLog, render_prometheus
from seist_tpu_torch.ops import pooled_attention
from seist_tpu_torch.serve.batcher import BatcherConfig, MicroBatcher
from seist_tpu_torch.serve.pool import ModelPool, clip_picks, decode_outputs
from seist_tpu_torch.serve.protocol import (
    BadRequest,
    PredictOptions,
    ServeError,
    ShuttingDown,
    json_bytes,
    parse_body,
    parse_tasks,
    parse_waveform,
)
from seist_tpu_torch.utils import logger as logger_mod
from seist_tpu_torch.utils.logger import logger

MAX_BODY_BYTES = 64 * 1024 * 1024


def bad_candidate_version() -> int:
    """``SEIST_FAULT_SERVE_BAD_CANDIDATE``: the model version that is
    deliberately bad (-1: none)."""
    raw = os.environ.get("SEIST_FAULT_SERVE_BAD_CANDIDATE", "")
    try:
        return int(raw) if raw.strip() else -1
    except ValueError:
        raise ValueError(f"SEIST_FAULT_SERVE_BAD_CANDIDATE must be an integer, got {raw!r}") from None


class _BadCandidate(ServeError):
    """The entry serves the injected bad version: every /predict errors."""

    status = 500
    code = "bad_candidate"


class ServeService:
    """Transport-free serving core: every public method raises ServeError
    subclasses on failure and returns JSON-able dicts on success. The pool
    is warmed up (every program captured, every variant gated) before the
    service exists; then one batcher per (entry, variant) starts, keyed by
    the model name for fp32 and ``<model>@<variant>`` otherwise. A batcher
    resolves its entry from the pool at every flush, so a reload takes
    effect at the next flush."""

    def __init__(self, pool: ModelPool, config: BatcherConfig):
        self.pool = pool
        self.config = config
        self.buckets = config.resolved_buckets()
        t0 = time.perf_counter()
        pool.warmup(self.buckets)
        #: Wall seconds from the warm-up's start to ready: every capture and gate.
        self.ready_s = time.perf_counter() - t0
        self._bad_version = bad_candidate_version()
        self._batchers: Dict[str, MicroBatcher] = {}
        for name, entry in pool.entries().items():
            for variant in entry.variants:
                key = self._batcher_key(name, variant)
                self._batchers[key] = MicroBatcher(self._make_forward(name, variant), config,
                                                   name=key)
        self._reload_lock = threading.Lock()
        self._lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._reloads: Dict[str, int] = {}
        self._draining = False
        self._started = time.monotonic()
        # The service's half of /metrics on the bus (batchers publish their
        # own, labelled); a restarted service replaces its predecessor.
        BUS.register_collector("serve", self._bus_metrics)

    @property
    def entries(self) -> Dict[str, Any]:
        """The served entries by name."""
        return self.pool.entries()

    @staticmethod
    def _batcher_key(name: str, variant: str) -> str:
        return name if variant == "fp32" else f"{name}@{variant}"

    def _make_forward(self, name: str, variant: str):
        """The flush-time forward of one (entry, variant) batcher."""

        def forward(batch, tasks=None):
            entry = self.pool.get(name)
            if entry.is_group:
                return entry.fanout(batch, sorted(tasks or entry.tasks), variant)
            return entry.run(batch, variant)

        return forward

    def _check_variant(self, entry: Any, variant: str, tasks: Any) -> None:
        if variant == "fp32":
            return
        if variant not in entry.variants:
            raise BadRequest(
                f"variant '{variant}' is not loaded for model '{entry.name}' (serve "
                f"--variants); loaded: {list(entry.variants)}")
        supported = entry.supported_variants(tasks)
        if variant not in supported:
            raise BadRequest(
                f"variant '{variant}' is not served for this request (model '{entry.name}'"
                + (f", tasks {list(tasks)}" if tasks else "")
                + f"); available: {supported}: variants are parity-gated against fp32 at load")

    def predict(self, data: Any, model: Optional[str] = None,
                options: Optional[Dict[str, Any]] = None,
                tasks: Optional[Any] = None,
                trace: Optional[obs_trace.RequestTrace] = None) -> Dict[str, Any]:
        """One fixed-window trace through the micro-batcher. ``tasks``
        (task groups only): the heads to answer with, from one trunk run;
        by default every head of the group. ``trace`` (minted by the HTTP
        handler) records the stages as spans."""
        with self._lock:
            self._requests += 1
        try:
            return self._predict(data, model, options, tasks, trace)
        except ServeError:
            with self._lock:
                self._errors += 1
            raise

    def _predict(self, data: Any, model: Optional[str], options: Optional[Dict[str, Any]],
                 tasks: Optional[Any], trace: Optional[obs_trace.RequestTrace]) -> Dict[str, Any]:
        t = obs_trace.ensure(trace)
        if self._draining:
            raise ShuttingDown("service is draining")
        entry = self.pool.get(model)
        version = entry.version
        opts = PredictOptions.from_dict(options)
        req_tasks = entry.resolve_tasks(parse_tasks(tasks))
        self._check_variant(entry, opts.variant, req_tasks)
        if version == self._bad_version:
            raise _BadCandidate(f"model '{entry.name}' version {version} is the injected bad "
                                "candidate (SEIST_FAULT_SERVE_BAD_CANDIDATE)")
        if opts.norm_mode not in NORM_MODES:
            raise BadRequest(f"norm_mode must be one of {NORM_MODES}, got '{opts.norm_mode}'")
        with t.span("parse"):
            x = parse_waveform(data, entry.in_channels)
        if x.shape[0] > entry.window:
            raise BadRequest(f"trace length {x.shape[0]} > window {entry.window}")
        with t.span("normalize"):
            x = np.asarray(normalize(x, opts.norm_mode, axis=0), np.float32)
            n_real = x.shape[0]
            if n_real < entry.window:  # pad AFTER normalize: zeros stay 0
                x = np.concatenate(
                    [x, np.zeros((entry.window - n_real, x.shape[1]), np.float32)]
                )
        raw = self._batchers[self._batcher_key(entry.name, opts.variant)].submit(
            x, timeout_ms=opts.timeout_ms,
            tasks=frozenset(req_tasks) if req_tasks is not None else None, trace=trace)
        fs = float(opts.sampling_rate)
        if req_tasks is not None:  # a task group: one result per head asked for
            per_task = {}
            with t.span("decode", heads=",".join(req_tasks)):
                for task in req_tasks:
                    r = decode_outputs(entry.heads[task], raw[task], opts)
                    if n_real < entry.window:
                        clip_picks(r, n_real, fs)
                    per_task[task] = r
            return {"model": entry.name, "model_version": version, "tasks": per_task,
                    "trunk_runs": 1, "variant": opts.variant}
        with t.span("decode"):
            result = decode_outputs(entry, raw, opts)
        if n_real < entry.window:
            # The signal->zeros step at the padding boundary can fabricate
            # picks inside samples the client never sent.
            clip_picks(result, n_real, fs)
        result["model"] = entry.name
        result["model_version"] = version
        return result

    # ------------------------------------------------------------- reload
    def reload(self, model: Optional[str] = None, checkpoint: Optional[str] = None,
               checkpoints: Optional[Dict[str, str]] = None,
               version: Optional[Any] = None) -> Dict[str, Any]:
        """Hot-swap one entry for a new checkpoint (``POST
        /admin/reload``): the candidate is built and gated beside the
        incumbent (``ModelPool.reload``), which serves throughout; a
        failure leaves it serving and raises the structured error."""
        if self._draining:
            raise ShuttingDown("service is draining; not accepting reloads")
        entry = self.pool.get(model)
        if checkpoint is not None and not isinstance(checkpoint, str):
            raise BadRequest("'checkpoint' must be a string path")
        if checkpoints is not None and not (
                isinstance(checkpoints, dict)
                and all(isinstance(k, str) and isinstance(v, str)
                        for k, v in checkpoints.items())):
            raise BadRequest("'checkpoints' must be {task: path} strings")
        if version is not None:
            if isinstance(version, bool) or not isinstance(version, (int, str)):
                raise BadRequest(f"'version' must be an integer, got {version!r}")
            try:
                version = int(version)
            except ValueError:
                raise BadRequest(f"'version' must be an integer, got {version!r}") from None
        with self._reload_lock:  # one reload at a time
            previous = entry.version
            target = version if version is not None else previous + 1
            t0 = time.perf_counter()
            try:
                new_entry, report = self.pool.reload(
                    entry.name, buckets=self.buckets, checkpoint=checkpoint,
                    checkpoints=checkpoints, version=target,
                    force_gate_failure=target == self._bad_version)
            except ServeError as e:
                self._count_reload(e.code)
                logger.warning(f"[serve] reload '{entry.name}' to version {target} refused: "
                               f"{e}")
                raise
            reload_s = time.perf_counter() - t0
            self._count_reload("ok")
            return {"model": entry.name, "version": target, "previous_version": previous,
                    "variants": new_entry.supported_variants(), "programs": len(report),
                    "reload_s": round(reload_s, 3)}

    def _count_reload(self, outcome: str) -> None:
        with self._lock:
            self._reloads[outcome] = self._reloads.get(outcome, 0) + 1

    # ------------------------------------------------------ health/metrics
    def healthz(self) -> Dict[str, Any]:
        entries = {}
        for name, e in self.entries.items():
            info: Dict[str, Any] = {"version": e.version, "variants": e.supported_variants()}
            if e.is_group:
                info["tasks"] = list(e.tasks)
            entries[name] = info
        return {
            "status": "draining" if self._draining else "ok",
            "models": self.pool.names(),
            "entries": entries,
            "devices": {n: str(e.device) for n, e in self.entries.items()},
            "window": {n: e.window for n, e in self.entries.items()},
            "buckets": list(self.buckets),
            "healthy": self.alive(),
            "ready_s": round(self.ready_s, 3),
            "programs": self.pool.program_stats,
            "warmup": self.pool.warmup_report,
        }

    def alive(self) -> bool:
        return all(b.healthy for b in self._batchers.values())

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            requests, errors, reloads = self._requests, self._errors, dict(self._reloads)
        entries = self.entries
        return {
            "uptime_s": round(time.monotonic() - self._started, 3),
            "requests": requests,
            "errors": errors,
            "reloads": reloads,
            "models": {n: b.stats() for n, b in self._batchers.items()},
            "kernels": {
                "pooled_attention_fwd": {"launches": pooled_attention.launches},
                "pooled_attention_fwd_bf16": {"launches": pooled_attention.bf16_launches},
            },
            # Capture seconds stand where the JAX package reports compile ms.
            "programs": self.pool.program_stats,
            "graph_captures": sum(p.graph is not None for e in entries.values()
                                  for p in e.all_programs()),
            "fallback_runs": sum(e.fallback_runs for e in entries.values()),
            # Task groups: trunk runs, head runs, trunk FLOPs saved, gates.
            "fanout": {n: e.fanout_stats() for n, e in entries.items() if e.is_group},
            "warmup": self.pool.warmup_report,
        }

    def _bus_metrics(self) -> Dict[str, Any]:
        """The bus collector's payload: :meth:`metrics` without the
        per-model stats, which each batcher publishes itself, labelled."""
        m = self.metrics()
        m.pop("models", None)
        return m

    def begin_drain(self) -> None:
        self._draining = True

    def shutdown(self, drain: bool = True) -> None:
        self.begin_drain()
        for b in self._batchers.values():
            b.shutdown(drain=drain)
        # A shut-down service neither pins the pool through the bus nor
        # reports stale counters as live.
        BUS.unregister_collector("serve", fn=self._bus_metrics)


class _Handler(BaseHTTPRequestHandler):
    server_version = "seist-torch-serve/0.1"
    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> ServeService:
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, format: str, *args: Any) -> None:
        logger.debug(f"[serve] {self.address_string()} {format % args}")

    def _reply(self, status: int, payload: Dict[str, Any],
               extra_headers: Optional[Dict[str, str]] = None) -> None:
        self._send(status, json_bytes(payload), "application/json", extra_headers)

    def _send(self, status: int, body: bytes, ctype: str,
              extra_headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        try:
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                self._reply(200, self.service.healthz())
            elif path == "/metrics.json":
                self._reply(200, BUS.snapshot())
            elif path.startswith("/traces"):
                routed = obs_trace.handle_traces_path(self.path)
                if routed is None:
                    self._reply(404, {"error": "not_found", "message": self.path})
                else:
                    self._reply(*routed)
            elif path == "/metrics":
                # ?format=prometheus selects the text exposition whatever
                # else the query holds; bare /metrics stays the JSON.
                query = parse_qs(urlparse(self.path).query)
                if "prometheus" in query.get("format", []):
                    self._send(200, render_prometheus(BUS).encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._reply(200, self.service.metrics())
            else:
                self._reply(404, {"error": "not_found", "message": self.path})
        except Exception as e:  # noqa: BLE001 — a handler bug answers 500, the server lives
            logger.exception(f"[serve] unhandled error: {e!r}")
            obs_flight.dump_on_death("serve_handler_exception", arm_dedup=False,
                                     request_path=self.path, error=repr(e))
            self._reply(500, {"error": "internal", "message": repr(e)})

    @staticmethod
    def _trace_headers(rt: Optional[obs_trace.RequestTrace], status: int) -> Dict[str, str]:
        """Finish the request's trace; its ``Server-Timing`` and the
        ``traceparent`` echo (a client that minted no id can still fetch
        ``/traces/<id>``)."""
        if rt is None:
            return {}
        rt.finish(status)
        return {"Server-Timing": rt.server_timing(),
                obs_trace.TRACEPARENT_HEADER: rt.traceparent}

    def do_POST(self) -> None:  # noqa: N802
        rt: Optional[obs_trace.RequestTrace] = None
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_BODY_BYTES:
                # The unread body would desync this keep-alive connection.
                self.close_connection = True
                self._reply(413, {"error": "too_large",
                                  "message": f"body {length} > {MAX_BODY_BYTES} bytes"})
                return
            raw = self.rfile.read(length)
            if self.path == "/predict":
                # Continue the caller's trace, or mint one here.
                rt = obs_trace.RequestTrace(self.headers.get(obs_trace.TRACEPARENT_HEADER),
                                            name=f"server:{self.path}")
                body = parse_body(raw)
                result = self.service.predict(body.get("data"), model=body.get("model"),
                                              options=body.get("options"),
                                              tasks=body.get("tasks"), trace=rt)
            elif self.path == "/admin/reload":
                body = parse_body(raw)
                result = self.service.reload(model=body.get("model"),
                                             checkpoint=body.get("checkpoint"),
                                             checkpoints=body.get("checkpoints"),
                                             version=body.get("version"))
            else:
                self._reply(404, {"error": "not_found", "message": self.path})
                return
            self._reply(200, result, self._trace_headers(rt, 200))
        except ServeError as e:
            self._reply(e.status, e.payload(), self._trace_headers(rt, e.status))
        except Exception as e:  # noqa: BLE001 — a handler bug answers 500, the server lives
            logger.exception(f"[serve] unhandled error: {e!r}")
            obs_flight.dump_on_death("serve_handler_exception", arm_dedup=False,
                                     request_path=self.path, error=repr(e))
            self._reply(500, {"error": "internal", "message": repr(e)},
                        self._trace_headers(rt, 500))


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
    models: Sequence[Tuple[str, str]] = (),
    *,
    groups: Sequence[Tuple[str, Sequence[Tuple[str, str]]]] = (),
    window: int = 8192,
    device: str = "cuda",
    max_batch: int = 8,
    max_delay_ms: float = 10.0,
    max_queue: int = 64,
    buckets: Optional[Sequence[int]] = None,
    variants: Sequence[str] = ("fp32",),
    version: int = 1,
) -> ServeService:
    """Load ``(name, weights)`` entries and ``(prefix, [(task, weights)])``
    groups on ``device``, capture their programs and gate their variants."""
    pool = ModelPool(models, groups=groups, window=window, variants=variants, version=version,
                     device=device)
    return ServeService(pool, BatcherConfig(max_batch=max_batch, max_delay_ms=max_delay_ms,
                                            max_queue=max_queue, buckets=buckets))


def parse_model_flags(args: argparse.Namespace) -> List[Tuple[str, str]]:
    """``--model NAME[=WEIGHTS]`` (repeatable) and ``--model-name`` /
    ``--checkpoint`` -> [(name, weights)]."""
    entries = [tuple(spec.partition("=")[::2]) for spec in args.model]
    if args.model_name:
        entries.append((args.model_name, args.checkpoint))
    return entries


def parse_group_flags(args: argparse.Namespace) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """``--model-group PREFIX=TASK[:WEIGHTS],...`` -> [(prefix, [(task, weights)])]."""
    groups = []
    for spec in args.model_group or []:
        prefix, sep, rest = spec.partition("=")
        if not sep or not prefix or not rest:
            raise SystemExit(f"serve: bad --model-group '{spec}' "
                             "(want PREFIX=TASK[:WEIGHTS],TASK[:WEIGHTS],...)")
        tasks = []
        for part in rest.split(","):
            task, _, weights = part.partition(":")
            if not task:
                raise SystemExit(f"serve: empty task in --model-group '{spec}'")
            tasks.append((task, weights))
        groups.append((prefix, tasks))
    return groups


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
    ap.add_argument(
        "--model-group", action="append", default=[],
        metavar="PREFIX=TASK[:WEIGHTS],TASK[:WEIGHTS],...",
        help="a SeisT task group: the PREFIX_TASK models on ONE shared trunk (the first "
        "task's), e.g. seist_l=dpk,emg:W.pt,dis; a /predict runs the trunk once and "
        "answers each requested task",
    )
    ap.add_argument(
        "--variants", default="fp32",
        help="comma-separated weight variants to capture programs for: fp32,bf16,int8 "
        "(chosen per request by options.variant; bf16 and int8 are parity-gated "
        "against fp32 at load)",
    )
    ap.add_argument("--model-name", default="", help="single-model shorthand")
    ap.add_argument("--checkpoint", default="", help="weights of --model-name")
    ap.add_argument(
        "--model-version", type=int,
        default=int(os.environ.get("SEIST_MODEL_VERSION", "") or 1),
        help="monotonic version of the loaded weights (default $SEIST_MODEL_VERSION or 1), "
        "in every response and /healthz; /admin/reload installs a higher one",
    )
    ap.add_argument("--window", type=int, default=8192)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=10.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument(
        "--buckets", default="",
        help="comma-separated batch buckets (default: powers of 2 up to --max-batch); the "
        "largest must equal --max-batch",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.model and not args.model_name and not args.model_group:
        ap.error("need --model NAME[=WEIGHTS], --model-name or --model-group")
    return args


def service_from_args(args: argparse.Namespace) -> ServeService:
    """The service ``serve`` runs for parsed :func:`get_serve_args`."""
    return build_service(
        parse_model_flags(args),
        groups=parse_group_flags(args),
        window=args.window,
        device=args.device,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        max_queue=args.max_queue,
        buckets=[int(b) for b in args.buckets.split(",")] if args.buckets else None,
        variants=[v.strip() for v in args.variants.split(",") if v.strip()],
        version=args.model_version,
    )


def start_telemetry() -> EventLog:
    """The serving process's telemetry (``seist_tpu/serve/server.py``
    main): a flight recorder, whose ring takes every request span through
    the bus and which the serve death paths dump; the trace buffer's
    retention counters on the bus; and the returned event log,
    ``events<replica suffix>.jsonl`` in the log directory (the suffix keeps
    the replicas of a fleet sharing one directory apart)."""
    obs_flight.install(obs_flight.FlightRecorder())
    obs_trace.register_trace_collector()
    return EventLog(os.path.join(logger_mod.logdir(),
                                 f"events{obs_trace.replica_suffix()}.jsonl"))


def main(argv: Optional[List[str]] = None) -> None:
    import signal

    args = get_serve_args(argv)
    events = start_telemetry()
    service = service_from_args(args)
    server = start_http_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    logger.info(
        f"[serve] listening on http://{host}:{port} models={service.pool.names()} "
        f"buckets={list(service.buckets)} device={args.device} ready in "
        f"{service.ready_s:.2f} s"
    )
    events.emit("serve_state", state="ok", ready_s=round(service.ready_s, 3))
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
            # The batcher's own death dumped the richer record moments ago.
            obs_flight.dump_on_death("serve_unhealthy", dedup_s=5.0,
                                     detail="batcher worker died")
            rc = 1
            break
    logger.info("[serve] draining...")
    events.emit("serve_state", state="draining", rc=rc)
    service.shutdown(drain=rc == 0)
    server.shutdown()
    logger.info(f"[serve] stopped (rc={rc})")
    events.emit("serve_state", state="stopped", rc=rc)
    events.close()
    obs_flight.install(None)
    if rc:
        raise SystemExit(rc)
