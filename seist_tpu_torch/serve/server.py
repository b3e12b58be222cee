"""Online inference service of the port: ``POST /predict``,
``POST /annotate``, ``POST /stream``, ``POST /admin/reload``,
``GET /healthz``, ``GET /healthz/live``, ``GET /healthz/ready``,
``GET /stream/alerts``, ``GET /metrics``, ``GET /metrics.json``,
``GET /traces[/<id>]``.

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

``serve`` opens its socket before the warm-up (``warmup_async``): while
the programs are captured, ``/healthz/live`` answers 200 and
``/healthz/ready`` 503 with state ``warming``, and a request that arrives
is still served, eagerly (counted in ``fallback_runs``). A failed
warm-up makes the replica dead, and the process exits 1. SIGTERM drains
(queued requests are served, new ones get 503) and exits
``PREEMPT_EXIT_CODE`` (75), the managed preemption a fleet supervisor
relaunches at once; SIGINT drains and exits 0; a dead batcher exits 1.

``POST /annotate`` picks over a record of any length at least one window
long: ``ops/stream.annotate`` cuts it into windows, runs them through the
entry's largest-bucket fp32 program (a group's trunk and dpk head,
``MultiTaskEntry.picker_forward``), stitches and picks on the card, one
record per model at a time. ``POST /stream`` feeds one station's packet
into its ``stream.StreamSession`` (``stream/mux.py``); the windows that
fall due ride the fp32 batcher at the ``alert`` rank, and their picks,
final once no later window can cover them, equal ``/annotate``'s over the
concatenated record. An ``Associator`` turns picks of several stations
into network alerts (``GET /stream/alerts``); with
``--stream-journal-dir`` the sessions are journaled and the alerts
written ahead, so a restarted replica resumes its stations and does not
alert twice. Every request route passes a per-model
``serve/shed.py::AdmissionController`` first (``options.priority``:
``batch`` is shed before ``interactive`` before ``alert``, with 503 and
``Retry-After``). ``/healthz/live`` and ``/healthz/ready`` answer 503 when
the replica is dead, or not ready (draining); ``/healthz/ready`` carries
each model's served version.

Tracing (``obs/trace.py``): every ``/predict``, ``/annotate`` and
``/stream`` continues the request's ``traceparent`` or mints one, and
records its spans: ``admission`` (with the shed verdict), ``parse``, then
``normalize``, ``queue_wait``, ``forward`` and ``decode`` (``/predict``),
``stream`` (``/annotate``) or ``stream_feed`` (``/stream``); every reply
to one, errors included, carries ``Server-Timing`` (``total`` and each span)
and the ``traceparent`` echo, and ``GET /traces/<trace id>`` returns the
spans. ``serve`` also writes ``events<replica>.jsonl`` and installs a
flight recorder in its log directory (``./logs``), dumped when a batcher
thread dies or a handler raises.

    python -m seist_tpu_torch serve --model seist_l_dpk[=WEIGHTS.pt] --window 8192 \\
        [--model-group seist_l=dpk,emg:W.pt,dis] [--variants fp32,bf16,int8]

Faults (``utils/faults.py``): ``SEIST_FAULT_SERVE_*`` (kill at request
k, a slow forward, a black hole, a bad candidate version: a reload to it
fails its gate, and an entry serving it answers every ``/predict`` with a
500) and ``SEIST_FAULT_STREAM_*`` (packet drop, duplicate, reorder, kill
at packet k, journal corruption).
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
from seist_tpu_torch.ops.stream import annotate as stream_annotate
from seist_tpu_torch.ops.stream import window_offsets
from seist_tpu_torch.serve.pool import ModelPool, clip_picks, decode_outputs
from seist_tpu_torch.serve.protocol import (
    PRIORITIES,
    BadRequest,
    DeadlineExceeded,
    Overloaded,
    PredictOptions,
    QueueFull,
    ReloadFailed,
    ServeError,
    ShuttingDown,
    json_bytes,
    parse_body,
    parse_station,
    parse_tasks,
    parse_waveform,
)
from seist_tpu_torch.serve.shed import AdmissionController, ShedConfig
from seist_tpu_torch.stream.assoc import AssocConfig, Associator
from seist_tpu_torch.stream.journal import AlertWAL, StationJournal
from seist_tpu_torch.stream.mux import MuxClosed, MuxConfig, StationLimit, StationMux
from seist_tpu_torch.stream.session import SessionConfig
from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE
from seist_tpu_torch.utils import logger as logger_mod
from seist_tpu_torch.utils.faults import ServeFaultInjector, stream_faults
from seist_tpu_torch.utils.logger import logger
from seist_tpu_torch.utils.meters import LatencyHistogram

MAX_BODY_BYTES = 64 * 1024 * 1024

#: The replica's lifecycle (warming -> ok -> draining, or dead) as the
#: ``serve_state_code`` gauge, the JAX package's codes. A replica is
#: "warming" while its programs are captured (``warmup_async``).
STATE_CODES = {"dead": 0, "warming": 1, "ok": 2, "draining": 3}


class _BadCandidate(ServeError):
    """The entry serves the injected bad version: every /predict errors."""

    status = 500
    code = "bad_candidate"


class ServeService:
    """Transport-free serving core: every public method raises ServeError
    subclasses on failure and returns JSON-able dicts on success. One
    batcher per (entry, variant) starts, keyed by the model name for fp32
    and ``<model>@<variant>`` otherwise, and one admission controller per
    entry, fed by the worst ``queue_delay_ms`` over its batchers. A batcher
    resolves its entry from the pool at every flush, so a reload takes
    effect at the next flush.

    The warm-up (every program captured, every variant gated) runs in the
    constructor, or with ``warmup_async`` on a thread of its own while the
    service already serves: readiness waits for it, and a request that
    arrives meanwhile runs eagerly (an entry publishes a variant's programs
    once all of its buckets are captured). A failed warm-up raises from the
    constructor, or, async, makes the service dead.

    ``stream_config`` holds the stream plane's serve flags:
    ``max_stations``, ``idle_timeout_s``, ``journal_dir``,
    ``journal_every_s`` and the associator's ``assoc_*``."""

    def __init__(self, pool: ModelPool, config: BatcherConfig,
                 shed_config: Optional[ShedConfig] = None,
                 stream_config: Optional[Dict[str, Any]] = None,
                 event_log: Optional[EventLog] = None,
                 warmup_async: bool = False):
        self.pool = pool
        self.config = config
        self.buckets = config.resolved_buckets()
        self.shed_config = shed_config or ShedConfig()
        self._faults = ServeFaultInjector.from_env()
        self._event_log = event_log
        self._lock = threading.Lock()
        self._draining = False
        self._last_state: Optional[str] = None
        self._batchers: Dict[str, MicroBatcher] = {}
        # Readiness waits for the warm-up; liveness fails if it fails.
        self._warming = True
        self._warmup_error: Optional[Exception] = None
        #: Wall seconds from the warm-up's start to ready: every capture and
        #: gate (None until the warm-up is done).
        self.ready_s: Optional[float] = None
        self._shedders: Dict[str, AdmissionController] = {}
        for name, entry in pool.entries().items():
            mine = []
            for variant in entry.variants:
                key = self._batcher_key(name, variant)
                self._batchers[key] = MicroBatcher(self._make_forward(name, variant), config,
                                                   name=key)
                mine.append(self._batchers[key])
            # Overload on any variant sheds the entry.
            self._shedders[name] = AdmissionController(
                lambda _bs=tuple(mine): max(b.queue_delay_ms() for b in _bs),
                self.shed_config, model=name)
        self._annotate_locks = {n: threading.Lock() for n in pool.names()}
        self.annotate_latency_ms = LatencyHistogram()
        self._annotate_windows = 0
        # /stream: one StationMux per picking model, made at its first packet.
        self._stream_config = dict(stream_config or {})
        self._stream_muxes: Dict[str, StationMux] = {}
        self._stream_lock = threading.Lock()
        # The process's stream injector (journal.py's corrupt hook shares
        # it); a reordered packet waits here for its station's next one.
        self._stream_faults = stream_faults()
        self._held_packets: Dict[Tuple[str, str], Any] = {}
        self._reload_lock = threading.Lock()
        self._requests = {"predict": 0, "annotate": 0, "stream": 0}
        self._errors = 0
        self._reloads: Dict[str, int] = {}
        self._started = time.monotonic()
        # The service's half of /metrics on the bus (batchers and shedders
        # publish their own, labelled); a restarted service replaces it.
        BUS.register_collector("serve", self._bus_metrics)
        self.publish_state("startup")
        if warmup_async:
            self._warmup_thread: Optional[threading.Thread] = threading.Thread(
                target=self._run_warmup, name="serve-warmup", daemon=True)
            self._warmup_thread.start()
        else:
            self._warmup_thread = None
            self._run_warmup()
            if self._warmup_error is not None:
                self.shutdown(drain=False)
                raise self._warmup_error

    def _run_warmup(self) -> None:
        t0 = time.perf_counter()
        try:
            self.pool.warmup(self.buckets)
        except Exception as e:  # noqa: BLE001 - recorded: liveness fails, main exits 1
            self._warmup_error = e
            logger.warning(f"[serve] warm-up failed: {e!r}")
            self.publish_state("warmup_failed")
            return
        self.ready_s = time.perf_counter() - t0
        self._warming = False
        logger.info(f"[serve] ready in {self.ready_s:.2f} s")
        self.publish_state("warmup_done")

    def wait_warmup(self, timeout: Optional[float] = None) -> bool:
        """Block until the warm-up has ended (done or failed); True if it has."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout)
        return not self._warming or self._warmup_error is not None

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
            # An injected slow model sleeps in the flush thread, so queued
            # requests age as behind a slow card.
            self._faults.forward_delay()
            if entry.is_group:
                return entry.fanout(batch, sorted(tasks or entry.tasks), variant)
            return entry.run(batch, variant)

        return forward

    # ------------------------------------------------------ lifecycle state
    def publish_state(self, reason: str = "") -> None:
        """The lifecycle (warming -> ok -> draining, or dead) as the
        ``serve_state_code`` gauge, an ``events.jsonl`` event and a flight
        recorder event; a call that changes nothing publishes nothing."""
        state = self._state_str()
        with self._lock:
            if state == self._last_state:
                return
            prev, self._last_state = self._last_state, state
        BUS.gauge("serve_state_code").set(STATE_CODES.get(state, 0))
        if self._event_log is not None:
            self._event_log.emit("serve_state", state=state, prev=prev, reason=reason)
        rec = obs_flight.get()
        if rec is not None:
            rec.record_event("serve_state", state=state, prev=prev, reason=reason)
        logger.info(f"[serve] state {prev or 'start'} -> {state}"
                    + (f" ({reason})" if reason else ""))

    def _check_variant(self, entry: Any, variant: str, tasks: Any) -> None:
        if variant == "fp32":
            return
        if variant not in entry.variants:
            raise BadRequest(
                f"variant '{variant}' is not loaded for model '{entry.name}' (serve "
                f"--variants); loaded: {list(entry.variants)}")
        if self._warming:
            # The gates run in the warm-up; until then a loaded variant is
            # served eagerly, as fp32 is.
            return
        supported = entry.supported_variants(tasks)
        if variant not in supported:
            raise BadRequest(
                f"variant '{variant}' is not served for this request (model '{entry.name}'"
                + (f", tasks {list(tasks)}" if tasks else "")
                + f"); available: {supported}: variants are parity-gated against fp32 at load")

    def _admit(self, t: obs_trace.RequestTrace, entry: Any, tier: str,
               final: bool = False) -> None:
        """The entry's admission gate, as the request's ``admission`` span."""
        with t.span("admission", tier=tier) as sp:
            try:
                self._shedders[entry.name].admit(tier, final=final)
            except Overloaded as e:
                sp.annotate(verdict="shed", retry_after_s=round(e.retry_after_s, 3))
                t.flag("shed")
                raise
            sp.annotate(verdict="admitted")

    def _count(self, route: str) -> int:
        with self._lock:
            self._requests[route] += 1
            return self._requests[route]

    # ----------------------------------------------------------- predict
    def predict(self, data: Any, model: Optional[str] = None,
                options: Optional[Dict[str, Any]] = None,
                tasks: Optional[Any] = None,
                station: Optional[Any] = None,
                trace: Optional[obs_trace.RequestTrace] = None) -> Dict[str, Any]:
        """One fixed-window trace through the micro-batcher. ``tasks``
        (task groups only): the heads to answer with, from one trunk run;
        by default every head of the group. ``station`` (optional ``{"id",
        "network", "lat", "lon"}``) is validated and echoed back. ``trace``
        (minted by the HTTP handler) records the stages as spans."""
        n = self._count("predict")
        try:
            return self._predict(data, model, options, tasks, station, trace, n)
        except ServeError:
            with self._lock:
                self._errors += 1
            raise

    def _predict(self, data: Any, model: Optional[str], options: Optional[Dict[str, Any]],
                 tasks: Optional[Any], station: Optional[Any],
                 trace: Optional[obs_trace.RequestTrace], n_request: int) -> Dict[str, Any]:
        t = obs_trace.ensure(trace)
        if self._draining:
            raise ShuttingDown("service is draining")
        entry = self.pool.get(model)
        version = entry.version
        opts = PredictOptions.from_dict(options)
        req_tasks = entry.resolve_tasks(parse_tasks(tasks))
        station_meta = parse_station(station)
        self._check_variant(entry, opts.variant, req_tasks)
        t.annotate(model=entry.name, variant=opts.variant, tier=opts.priority, version=version)
        if self._faults.is_bad_candidate(version):
            raise _BadCandidate(f"model '{entry.name}' version {version} is the injected bad "
                                "candidate (SEIST_FAULT_SERVE_BAD_CANDIDATE)")
        if opts.norm_mode not in NORM_MODES:
            raise BadRequest(f"norm_mode must be one of {NORM_MODES}, got '{opts.norm_mode}'")
        # Arrival: a scheduled kill or black hole, then the shed gate,
        # before the waveform's parse costs anything.
        self._faults.on_request(n_request)
        self._admit(t, entry, opts.priority)
        with t.span("parse"):
            x = parse_waveform(data, entry.in_channels)
        if x.shape[0] > entry.window:
            raise BadRequest(f"trace length {x.shape[0]} > window {entry.window}; "
                             "use POST /annotate for long records")
        with t.span("normalize"):
            x = np.asarray(normalize(x, opts.norm_mode, axis=0), np.float32)
            n_real = x.shape[0]
            if n_real < entry.window:  # pad AFTER normalize: zeros stay 0
                x = np.concatenate(
                    [x, np.zeros((entry.window - n_real, x.shape[1]), np.float32)]
                )
        raw = self._batchers[self._batcher_key(entry.name, opts.variant)].submit(
            x, timeout_ms=opts.timeout_ms, rank=PRIORITIES[opts.priority],
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
            out = {"model": entry.name, "model_version": version, "tasks": per_task,
                   "trunk_runs": 1, "variant": opts.variant}
            if station_meta is not None:
                out["station"] = station_meta
            return out
        with t.span("decode"):
            result = decode_outputs(entry, raw, opts)
        if n_real < entry.window:
            # The signal->zeros step at the padding boundary can fabricate
            # picks inside samples the client never sent.
            clip_picks(result, n_real, fs)
        result["model"] = entry.name
        result["model_version"] = version
        if station_meta is not None:
            result["station"] = station_meta
        return result

    # ---------------------------------------------------------- annotate
    def annotate(self, data: Any, model: Optional[str] = None,
                 options: Optional[Dict[str, Any]] = None,
                 trace: Optional[obs_trace.RequestTrace] = None) -> Dict[str, Any]:
        """A record at least one window long, through sliding windows and
        stitching on the entry's largest-bucket fp32 program (a group's
        trunk and dpk head)."""
        if self._draining:
            raise ShuttingDown("service is draining")
        t = obs_trace.ensure(trace)
        entry = self.pool.get(model)
        if not entry.is_picker:
            raise BadRequest(f"model '{entry.name}' is not a picking model; /annotate needs "
                             "(non|det, ppk, spk) outputs")
        opts = PredictOptions.from_dict(options)
        if opts.variant != "fp32":
            raise BadRequest("variant selection is /predict-only; /annotate always runs fp32")
        self._admit(t, entry, opts.priority)
        with t.span("parse"):
            record = parse_waveform(data, entry.in_channels)
        if record.shape[0] < entry.window:
            raise BadRequest(f"record length {record.shape[0]} < window {entry.window}; "
                             "use POST /predict for single windows")
        t0 = time.monotonic()
        lock = self._annotate_locks[entry.name]
        # One record at a time per model (one saturates the card); the wait
        # counts against the request's own deadline.
        if not lock.acquire(timeout=opts.timeout_ms / 1000.0):
            raise DeadlineExceeded(f"/annotate queue wait exceeded {opts.timeout_ms:.0f} ms")
        forward = entry.picker_forward if entry.is_group else (lambda x: entry.run(x, "fp32"))
        try:
            self._count("annotate")
            with t.span("stream", model=entry.name, record_samples=int(record.shape[0])):
                picks = stream_annotate(
                    forward, record, window=entry.window, stride=opts.stride or None,
                    batch_size=self.buckets[-1], sampling_rate=opts.sampling_rate,
                    ppk_threshold=opts.ppk_threshold, spk_threshold=opts.spk_threshold,
                    det_threshold=opts.det_threshold, min_peak_dist=opts.min_peak_dist,
                    combine=opts.combine, max_events=opts.record_max_events or None,
                    channel0=entry.channel0)
        finally:
            lock.release()
        self.annotate_latency_ms.observe((time.monotonic() - t0) * 1000.0)
        n_windows = len(window_offsets(record.shape[0], entry.window,
                                       opts.stride or entry.window // 2))
        with self._lock:
            self._annotate_windows += n_windows
        return {"model": entry.name, "model_version": entry.version, "task": "picking",
                "record_samples": int(record.shape[0]), "windows": int(n_windows),
                **_picks_json(picks, float(opts.sampling_rate))}

    # ------------------------------------------------------------- stream
    def _stream_mux_for(self, entry: Any, opts: PredictOptions) -> StationMux:
        """The model's StationMux, made at its first ``/stream`` packet from
        that packet's options and the server's ``stream_config``, then
        frozen: a model's stream tenant is one pick and stitch
        configuration for the whole network."""
        name = entry.name
        with self._stream_lock:
            mux = self._stream_muxes.get(name)
            if mux is not None:
                return mux
            sc = self._stream_config
            session = SessionConfig(
                window=entry.window, stride=opts.stride or entry.window // 2,
                in_channels=entry.in_channels, channel0=entry.channel0,
                combine=opts.combine, sampling_rate=opts.sampling_rate,
                ppk_threshold=opts.ppk_threshold, spk_threshold=opts.spk_threshold,
                det_threshold=opts.det_threshold, min_peak_dist=opts.min_peak_dist)
            # With a journal directory the sessions are journaled every
            # journal_every_s and each alert is written ahead; a restart
            # (or a survivor pointed at the same directory) resumes the
            # stations and seeds its dedup window from the WAL.
            journal_dir = sc.get("journal_dir") or None
            journal = wal = None
            if journal_dir:
                journal = StationJournal(str(journal_dir), model=name)
                # One WAL per replica: a fleet shares the directory.
                wal = AlertWAL(os.path.join(str(journal_dir), name,
                                            f"alerts{obs_trace.replica_suffix()}.wal"))
            assoc = Associator(AssocConfig(
                window_s=float(sc.get("assoc_window_s", 30.0)),
                min_stations=int(sc.get("assoc_min_stations", 4)),
                velocity_kms=float(sc.get("assoc_velocity_kms", 6.0)),
                tolerance_s=float(sc.get("assoc_tolerance_s", 2.0)),
                grid_step_deg=float(sc.get("assoc_grid_step_deg", 0.25)),
                dedup_window_s=float(sc.get("assoc_dedup_window_s", 2.0)),
            ), wal=wal)
            if wal is not None:
                seeded = assoc.seed_from_wal()
                if seeded:
                    logger.info(f"[serve] stream '{name}': seeded {seeded} WAL alerts into "
                                "the dedup window")
            batcher = self._batchers[self._batcher_key(name, "fp32")]
            timeout_ms = float(opts.timeout_ms)

            def submit(x, _b=batcher, _t=timeout_ms):
                # Due windows ride /predict's fp32 bucket programs, at alert rank.
                return _b.submit(x, timeout_ms=_t, rank=PRIORITIES["alert"])

            mux = StationMux(
                submit,
                MuxConfig(session=session, max_stations=int(sc.get("max_stations", 4096)),
                          idle_timeout_s=float(sc.get("idle_timeout_s", 900.0)),
                          journal_every_s=float(sc.get("journal_every_s", 5.0)), model=name),
                assoc=assoc, journal=journal)
            self._stream_muxes[name] = mux
            return mux

    @staticmethod
    def _synthetic_stream_result() -> Dict[str, Any]:
        """What a faulted (dropped or held) packet answers: a 200 with no
        picks, as a swallowed packet looks from outside."""
        return {"n_samples": 0, "windows": 0, "duplicate": False, "closed": False,
                "degraded": False, "dropped_windows": 0,
                "picks": {"ppk": [], "spk": [], "det": []}, "alerts": []}

    def stream(self, body: Dict[str, Any],
               trace: Optional[obs_trace.RequestTrace] = None) -> Dict[str, Any]:
        """One station packet (``POST /stream``): route it to the station's
        session, run the windows that fell due through the fp32 batcher at
        alert rank, and return the picks that became final and any network
        alerts. ``end=true`` flushes the tail window and closes the
        session. Packets are raw counts; the session normalizes each
        window as ``/annotate`` does."""
        if self._draining:
            raise ShuttingDown("service is draining")
        t = obs_trace.ensure(trace)
        entry = self.pool.get(body.get("model"))
        if not entry.is_picker:
            raise BadRequest(f"model '{entry.name}' is not a picking model; /stream needs "
                             "(non|det, ppk, spk) outputs")
        if entry.is_group:
            raise BadRequest(f"model '{entry.name}' is a multi-task group; /stream serves "
                             "single-task picking models")
        options = dict(body.get("options") or {})
        options.setdefault("priority", "alert")  # the early-warning path
        opts = PredictOptions.from_dict(options)
        if opts.variant != "fp32":
            raise BadRequest("variant selection is /predict-only; /stream always runs fp32")
        station = parse_station(body.get("station"), required=True)
        end = bool(body.get("end", False))
        seq = body.get("seq")
        if seq is not None and (isinstance(seq, bool) or not isinstance(seq, int)):
            raise BadRequest("'seq' must be an integer")
        version = entry.version
        t.annotate(model=entry.name, tier=opts.priority, station=station["id"],
                   version=version)
        n_request = self._count("stream")
        # A scheduled kill fires before admission: the shedder cannot dodge it.
        self._stream_faults.on_packet(n_request)
        # end=true releases a station slot: always admitted.
        self._admit(t, entry, opts.priority, final=end)
        with t.span("parse"):
            if body.get("data") is None:
                if not end:
                    raise BadRequest("'data' is required unless end=true (a bare end=true "
                                     "flushes and closes the session)")
                x = np.zeros((0, entry.in_channels), np.float32)
            else:
                x = parse_waveform(body.get("data"), entry.in_channels)
        mux = self._stream_mux_for(entry, opts)
        if n_request % 64 == 0:
            mux.reap_idle()  # sessions silent past idle_timeout_s
        # The packet's fate (SEIST_FAULT_STREAM_*): a dropped packet is
        # swallowed after its 200; a reordered one is held and fed after
        # the station's next packet, so it arrives stale.
        fate = "ok" if end else self._stream_faults.packet_fate(station["id"], seq)
        held_key = (entry.name, station["id"])
        try:
            with t.span("stream_feed", station=station["id"], packet_samples=int(x.shape[0]),
                        fate=fate):
                if fate == "drop":
                    t.flag("fault_drop")
                    result = self._synthetic_stream_result()
                elif fate == "reorder":
                    t.flag("fault_reorder")
                    with self._stream_lock:
                        prev_held = self._held_packets.pop(held_key, None)
                        self._held_packets[held_key] = (station, x, seq)
                    if prev_held is not None:  # two holds in a row: deliver the older
                        mux.feed(prev_held[0], prev_held[1], seq=prev_held[2], end=False)
                    result = self._synthetic_stream_result()
                else:
                    with self._stream_lock:
                        held = self._held_packets.pop(held_key, None)
                    if held is not None and end:
                        # Feed the held packet before the closing one.
                        mux.feed(held[0], held[1], seq=held[2], end=False)
                        held = None
                    result = mux.feed(station, x, seq=seq, end=end)
                    if held is not None:  # late: a stale seq, dropped idempotently
                        mux.feed(held[0], held[1], seq=held[2], end=False)
                    if fate == "dup":
                        t.flag("fault_dup")
                        mux.feed(station, x, seq=seq, end=False)
        except StationLimit as e:
            raise QueueFull(str(e)) from None  # back off, as from a full queue
        except MuxClosed as e:
            # Drain: a router retries the packet on a survivor, which
            # restores the station from its journal.
            raise ShuttingDown(str(e)) from None
        return {"model": entry.name, "model_version": version, "station": station,
                "n_samples": int(result["n_samples"]), "windows": int(result["windows"]),
                "duplicate": bool(result["duplicate"]), "closed": bool(result["closed"]),
                "degraded": bool(result["degraded"]),
                "dropped_windows": int(result["dropped_windows"]),
                **_picks_json(result["picks"], float(mux.config.session.sampling_rate)),
                "alerts": result["alerts"]}

    def stream_alerts(self, n: int = 50) -> Dict[str, Any]:
        """``GET /stream/alerts``: each streaming model's recent alerts and
        its mux's stats."""
        with self._stream_lock:
            muxes = dict(self._stream_muxes)
        return {"models": {name: {"alerts": mux.assoc.recent_alerts(n), "stats": mux.stats()}
                           for name, mux in muxes.items()}}

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
        if self._warming:
            raise ReloadFailed("initial warm-up still running; retry once /healthz/ready "
                               "reports ready")
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
                    force_gate_failure=self._faults.is_bad_candidate(target))
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
    def alive(self) -> bool:
        """Liveness: the warm-up did not fail and every batcher's worker
        thread runs (neither can come back, so the process exits 1 on it)."""
        return self._warmup_error is None and all(b.healthy for b in self._batchers.values())

    def ready(self) -> bool:
        """Readiness: alive, warmed up and not draining."""
        return self.alive() and not self._warming and not self._draining

    def _state_str(self) -> str:
        if not self.alive():
            return "dead"
        if self._draining:
            return "draining"
        return "warming" if self._warming else "ok"

    def model_versions(self) -> Dict[str, int]:
        """{model: served version}, on ``/healthz`` and ``/healthz/ready``
        (a router's prober tells a converged fleet from a rolling one)."""
        return {name: e.version for name, e in self.entries.items()}

    def healthz(self) -> Dict[str, Any]:
        entries = {}
        for name, e in self.entries.items():
            info: Dict[str, Any] = {"version": e.version, "variants": e.supported_variants()}
            if e.is_group:
                info["tasks"] = list(e.tasks)
            entries[name] = info
        return {
            "status": self._state_str(),
            "live": self.alive(),
            "ready": self.ready(),
            "models": self.pool.names(),
            "entries": entries,
            "devices": {n: str(e.device) for n, e in self.entries.items()},
            "window": {n: e.window for n, e in self.entries.items()},
            "buckets": list(self.buckets),
            "healthy": self.alive(),
            "uptime_s": round(time.monotonic() - self._started, 3),
            "ready_s": None if self.ready_s is None else round(self.ready_s, 3),
            "programs": self.pool.program_stats,
            "warmup": self.pool.warmup_report,
        }

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            requests, errors, reloads = dict(self._requests), self._errors, dict(self._reloads)
            annotate_windows = self._annotate_windows
        with self._stream_lock:
            stream_stats = {name: mux.stats() for name, mux in self._stream_muxes.items()}
        entries = self.entries
        return {
            "uptime_s": round(time.monotonic() - self._started, 3),
            "requests": requests,
            "errors": errors,
            "reloads": reloads,
            "annotate": {"windows": annotate_windows,
                         "latency_ms": self.annotate_latency_ms.summary()},
            "models": {n: b.stats() for n, b in self._batchers.items()},
            "shed": {n: s.stats() for n, s in self._shedders.items()},
            # Per model: sessions, windows, picks, alerts (the stream_* and
            # assoc_* bus counters hold the same, labelled).
            "stream": stream_stats,
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
        """The bus collector's payload: :meth:`metrics` without what the
        batchers, the shedders and the muxes publish themselves, labelled."""
        m = self.metrics()
        for key in ("models", "shed", "stream"):
            m.pop(key, None)
        return m

    def begin_drain(self) -> None:
        """Not ready from now on (new requests get 503, ``/healthz/ready``
        fails) while queued work still finishes."""
        self._draining = True
        self.publish_state("drain")

    def shutdown(self, drain: bool = True) -> None:
        self._draining = True
        self.publish_state("shutdown")
        # The muxes close (journaling their sessions) before the batchers
        # stop: a window submitted to a stopped batcher would only fail.
        with self._stream_lock:
            muxes, self._stream_muxes = dict(self._stream_muxes), {}
        for mux in muxes.values():
            mux.close_all()
        for b in self._batchers.values():
            b.shutdown(drain=drain)
        for s in self._shedders.values():
            s.close()
        # A shut-down service neither pins the pool through the bus nor
        # reports stale counters as live.
        BUS.unregister_collector("serve", fn=self._bus_metrics)


def _picks_json(picks: Dict[str, Any], fs: float) -> Dict[str, List[Dict[str, Any]]]:
    """Sample picks and (onset, offset) intervals as ``/annotate`` and
    ``/stream`` answer them."""
    return {
        "ppk": [{"sample": int(i), "time_s": round(int(i) / fs, 6)} for i in picks["ppk"]],
        "spk": [{"sample": int(i), "time_s": round(int(i) / fs, 6)} for i in picks["spk"]],
        "det": [{"onset": int(a), "offset": int(b), "onset_s": round(int(a) / fs, 6),
                 "offset_s": round(int(b) / fs, 6)} for a, b in picks["det"]],
    }


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
            elif path == "/healthz/live":
                live = self.service.alive()
                self._reply(200 if live else 503, {"status": "ok" if live else "dead"})
            elif path == "/healthz/ready":
                ready = self.service.ready()
                self._reply(200 if ready else 503,
                            {"status": self.service._state_str(), "ready": ready,
                             "versions": self.service.model_versions()})
            elif path == "/stream/alerts":
                self._reply(200, self.service.stream_alerts())
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
            if self.path in ("/predict", "/annotate", "/stream"):
                # Continue the caller's trace, or mint one here.
                rt = obs_trace.RequestTrace(self.headers.get(obs_trace.TRACEPARENT_HEADER),
                                            name=f"server:{self.path}")
            if self.path == "/predict":
                body = parse_body(raw)
                result = self.service.predict(body.get("data"), model=body.get("model"),
                                              options=body.get("options"),
                                              tasks=body.get("tasks"),
                                              station=body.get("station"), trace=rt)
            elif self.path == "/annotate":
                body = parse_body(raw)
                result = self.service.annotate(body.get("data"), model=body.get("model"),
                                               options=body.get("options"), trace=rt)
            elif self.path == "/stream":
                result = self.service.stream(parse_body(raw), trace=rt)
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
            headers = e.headers()  # the shed path's Retry-After
            headers.update(self._trace_headers(rt, e.status))
            self._reply(e.status, e.payload(), headers)
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
    shed_config: Optional[ShedConfig] = None,
    stream_config: Optional[Dict[str, Any]] = None,
    event_log: Optional[EventLog] = None,
    warmup_async: bool = False,
) -> ServeService:
    """Load ``(name, weights)`` entries and ``(prefix, [(task, weights)])``
    groups on ``device``, capture their programs and gate their variants
    (on a thread of the service's own with ``warmup_async``)."""
    pool = ModelPool(models, groups=groups, window=window, variants=variants, version=version,
                     device=device)
    return ServeService(pool, BatcherConfig(max_batch=max_batch, max_delay_ms=max_delay_ms,
                                            max_queue=max_queue, buckets=buckets),
                        shed_config=shed_config, stream_config=stream_config,
                        event_log=event_log, warmup_async=warmup_async)


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
    # Tiered admission (serve/shed.py): per-tier queue-delay budgets; 'inf'
    # never sheds a tier.
    ap.add_argument("--shed-batch-delay-ms", type=float, default=50.0,
                    help="shed 'batch' tier above this queue delay")
    ap.add_argument("--shed-interactive-delay-ms", type=float, default=250.0,
                    help="shed 'interactive' tier above this queue delay")
    ap.add_argument("--shed-alert-delay-ms", type=float, default=float("inf"),
                    help="shed 'alert' tier above this queue delay (default: never; alerts "
                    "ride to the 429 bound)")
    # The stream plane (/stream): station capacity and cross-station association.
    ap.add_argument("--stream-max-stations", type=int, default=4096,
                    help="concurrent streaming sessions per model; new stations past this "
                    "get 429")
    ap.add_argument("--stream-idle-timeout-s", type=float, default=900.0,
                    help="reap a station's session after this much feed silence")
    ap.add_argument("--assoc-min-stations", type=int, default=4,
                    help="distinct co-detecting stations to raise a network alert")
    ap.add_argument("--assoc-window-s", type=float, default=30.0,
                    help="cross-station co-detection window")
    ap.add_argument("--assoc-velocity-kms", type=float, default=6.0,
                    help="P moveout velocity for origin back-projection")
    ap.add_argument("--assoc-tolerance-s", type=float, default=2.0,
                    help="origin-time coherence tolerance")
    ap.add_argument("--assoc-grid-step-deg", type=float, default=0.25,
                    help="origin grid-search resolution")
    ap.add_argument("--assoc-dedup-window-s", type=float, default=2.0,
                    help="suppress a network alert whose origin sits within this many "
                    "seconds (and dedup_dist_deg) of an already-emitted one: the "
                    "exactly-once half of the alert WAL contract")
    ap.add_argument("--stream-journal-dir", default=None,
                    help="directory for per-station session journals and the alert WAL; "
                    "share it across a fleet to enable failover re-homing (unset = no "
                    "journaling)")
    ap.add_argument("--stream-journal-every-s", type=float, default=5.0,
                    help="min seconds between journal writes per station")
    args = ap.parse_args(argv)
    if not args.model and not args.model_name and not args.model_group:
        ap.error("need --model NAME[=WEIGHTS], --model-name or --model-group")
    return args


def service_from_args(args: argparse.Namespace, event_log: Optional[EventLog] = None,
                      warmup_async: bool = False) -> ServeService:
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
        shed_config=ShedConfig(batch_delay_ms=args.shed_batch_delay_ms,
                               interactive_delay_ms=args.shed_interactive_delay_ms,
                               alert_delay_ms=args.shed_alert_delay_ms),
        stream_config={
            "max_stations": args.stream_max_stations,
            "idle_timeout_s": args.stream_idle_timeout_s,
            "assoc_min_stations": args.assoc_min_stations,
            "assoc_window_s": args.assoc_window_s,
            "assoc_velocity_kms": args.assoc_velocity_kms,
            "assoc_tolerance_s": args.assoc_tolerance_s,
            "assoc_grid_step_deg": args.assoc_grid_step_deg,
            "assoc_dedup_window_s": args.assoc_dedup_window_s,
            "journal_dir": args.stream_journal_dir,
            "journal_every_s": args.stream_journal_every_s,
        },
        event_log=event_log,
        warmup_async=warmup_async,
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


def watch_until_shutdown(service: ServeService, stop: threading.Event,
                         poll_s: float = 0.5) -> int:
    """The main thread's watchdog: block until ``stop`` (a signal) or the
    service dies (a batcher thread died, or the warm-up failed). Returns 0
    on ``stop`` and 1 on a death, after publishing the reason and dumping
    the flight recorder: a replica whose batcher died would otherwise sit
    while every request times out, and nothing would restart it."""
    while not stop.is_set():
        if not service.alive():
            sick = [n for n, b in service._batchers.items() if not b.healthy]
            reason = (f"batcher flush thread(s) died: {sick}" if sick
                      else f"warm-up failed: {service._warmup_error!r}")
            service.publish_state(reason)
            # The batcher's own death dumped the richer record moments ago.
            obs_flight.dump_on_death("serve_unhealthy", dedup_s=5.0, detail=reason)
            logger.warning(f"[serve] {reason}; exiting 1")
            return 1
        stop.wait(poll_s)
    return 0


def main(argv: Optional[List[str]] = None) -> None:
    import signal

    args = get_serve_args(argv)
    events = start_telemetry()
    # The socket comes up before the warm-up: /healthz/live answers 200
    # and /healthz/ready 503 "warming" while the programs are captured.
    service = service_from_args(args, event_log=events, warmup_async=True)
    server = start_http_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    logger.info(
        f"[serve] listening on http://{host}:{port} models={service.pool.names()} "
        f"buckets={list(service.buckets)} device={args.device} (warming up)"
    )
    stop = threading.Event()
    # SIGTERM is a managed preemption (a rolling restart, a node drain):
    # drain, then exit PREEMPT_EXIT_CODE so a fleet supervisor relaunches
    # at once with its crash budget untouched. SIGINT is an operator's
    # stop: drain and exit 0, and the slot is retired.
    exit_code = {"rc": 0}

    def _term(signum, frame):
        if signum == signal.SIGTERM:
            exit_code["rc"] = PREEMPT_EXIT_CODE
        service.begin_drain()
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    rc = watch_until_shutdown(service, stop)
    if rc == 0:
        rc = exit_code["rc"]
        logger.info("[serve] draining...")
        # A capture still running when the process exits could hang in
        # the CUDA teardown; a drain waits for the warm-up first.
        service.wait_warmup()
        service.shutdown(drain=True)
        server.shutdown()
        logger.info(f"[serve] stopped (rc={rc})")
    else:
        server.shutdown()
        service.shutdown(drain=False)
        logger.info("[serve] stopped (unhealthy)")
    events.emit("serve_state", state="stopped", rc=rc)
    events.close()
    obs_flight.install(None)
    if rc:
        raise SystemExit(rc)
