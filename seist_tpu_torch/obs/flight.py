"""Crash flight recorder: a fixed-size ring of the last N steps' records
and span events, dumped to JSON from every death path (the port's copy of
``seist_tpu/obs/flight.py``; the dump's keys are the JAX package's).

The train worker installs one (``--flight-steps``, default 256: a deque
append per step), and so does ``serve``. Death paths and their reasons:

================================  =======================================
death path                        dump reason
================================  =======================================
bad-update rollback               ``bad_update_rollback`` (run continues)
``io_guard.hard_exit``            ``hard_exit``
stall-watchdog trip               ``stall_watchdog``
SIGTERM preempt exit              ``preempt``
quarantine overflow               ``quarantine_overflow``
loader death                      (reaches ``hard_exit``)
uncaught train-worker exception   ``exception``
batcher flush-thread death        ``batcher_flush_death``
serve exit on a dead batcher      ``serve_unhealthy`` (deduplicated)
serve handler exception           ``serve_handler_exception`` (non-fatal)
================================  =======================================

Dumps land in ``<logdir>/flight/flight_<reason>[_r<N>]_<pid>_<seq>.json``
(``utils/logger.py::logdir``): pid and seq keep a relaunched attempt from
overwriting the last one's record, and a fleet ordinal keeps replicas
apart. The module keeps ONE installed recorder (:func:`install`,
:func:`get`); death paths call :func:`dump_on_death`, a no-op without
one, so library code (``data/io_guard.py``) works without the plane.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from seist_tpu_torch.utils import logger as logger_mod
from seist_tpu_torch.utils.logger import logger


class FlightRecorder:
    """Ring buffer of step records + span events + discrete events.

    ``record_step`` is the per-iteration hot call: one lock, one deque
    append. Spans arrive via the bus sink (:meth:`on_span`) tagged with
    the step current at the time they END, so a dump shows exactly which
    phases the final steps spent their time in.
    """

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._steps: Deque[Dict[str, Any]] = collections.deque(maxlen=capacity)
        # Spans outnumber steps (host-wait + dispatch + saves per step);
        # scale the span ring so it covers at least the step window.
        self._spans: Deque[Dict[str, Any]] = collections.deque(
            maxlen=8 * capacity
        )
        self._events: Deque[Dict[str, Any]] = collections.deque(maxlen=128)
        self._current_step: Optional[int] = None
        self._dump_seq = 0

    # ------------------------------------------------------------ record
    def record_step(self, step: int, **fields) -> None:
        rec = {"step": int(step), "t_mono": round(time.monotonic(), 6)}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._current_step = int(step)
            self._steps.append(rec)

    def on_span(self, span) -> None:
        """Bus span sink (``BUS.add_span_sink(recorder.on_span)``).

        Tagged with the step current when the span ENDS; the worker
        records step N before N's spans close, so dispatch/save spans
        carry their own step. The one convention: the host wait BETWEEN
        steps N-1 and N ends before ``record_step(N)`` runs and is
        tagged N-1 — read host_wait as "the wait after this step"."""
        with self._lock:
            self._spans.append(
                {
                    "name": span.name,
                    "step": self._current_step,
                    "dur_ms": round((span.duration_s or 0.0) * 1e3, 3),
                    **({"labels": span.labels} if span.labels else {}),
                }
            )

    def record_event(self, kind: str, message: str = "", **fields) -> None:
        rec: Dict[str, Any] = {
            "t": round(time.time(), 3),
            "kind": kind,
        }
        if message:
            rec["message"] = message
        with self._lock:
            rec["step"] = self._current_step
        rec.update(fields)
        with self._lock:
            self._events.append(rec)

    # -------------------------------------------------------------- dump
    def payload(self, reason: str, **fields) -> Dict[str, Any]:
        """The dump dict (also served live by the /flight endpoint)."""
        with self._lock:
            steps = list(self._steps)
            spans = list(self._spans)
            events = list(self._events)
            last_step = self._current_step
        out: Dict[str, Any] = {
            "reason": reason,
            "dumped_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "pid": os.getpid(),
            "last_step": last_step,
            "capacity": self.capacity,
            "steps": steps,
            "spans": spans,
            "events": events,
        }
        out.update(fields)
        try:
            from seist_tpu_torch.obs.bus import BUS

            out["metrics"] = BUS.snapshot()
        except Exception as e:  # noqa: BLE001 - the ring is the payload;
            # a sick collector must not lose the crash record
            out["metrics"] = {"error": repr(e)}
        return out

    def dump(
        self, reason: str, path: Optional[str] = None, **fields
    ) -> Optional[str]:
        """Write the JSON dump; returns the path (None when the write
        itself failed — death paths must still exit)."""
        if path is None:
            # The replica ordinal (SEIST_SERVE_REPLICA) disambiguates N
            # fleet members sharing one --logdir; pid+seq already keeps
            # relaunched attempts apart.
            from seist_tpu_torch.obs.trace import replica_suffix

            d = os.path.join(logger_mod.logdir(), "flight")
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            path = os.path.join(
                d,
                f"flight_{_slug(reason)}{replica_suffix()}"
                f"_{os.getpid()}_{seq}.json",
            )
        try:
            d = os.path.dirname(path) or "."
            os.makedirs(d, exist_ok=True)
            # Atomic publish: serialize into a dotfile (invisible to
            # flight_* globs) and rename into place — a watcher polling
            # for the dump must never read a half-written payload, and
            # the snapshot can be large enough late in a long run for
            # that window to be real.
            tmp = os.path.join(d, "." + os.path.basename(path) + ".tmp")
            with open(tmp, "w") as f:
                json.dump(self.payload(reason, **fields), f, default=str)
            os.replace(tmp, path)
        except OSError as e:
            try:
                logger.error(f"[obs] flight-recorder dump failed: {e!r}")
            except Exception:  # noqa: BLE001 - dying process, best effort
                pass
            return None
        try:
            logger.warning(f"[obs] flight recorder dumped: {path} ({reason})")
        except Exception:  # noqa: BLE001 - dying process, best effort
            pass
        return path


def _slug(s: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_") else "_" for c in s)[:64]


# ------------------------------------------------------- installed recorder
_INSTALLED: Optional[FlightRecorder] = None
_INSTALL_LOCK = threading.Lock()

#: Paths written by dump_on_death this process (newest last) — lets tests
#: and the worker's exit logs point at the artifact.
DUMPED: List[str] = []

_LAST_DUMP_MONO: Optional[float] = None


def install(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install ``recorder`` as the process flight recorder (None to
    uninstall); returns the previous one. The train worker installs at
    startup; death paths anywhere in the process then reach it via
    :func:`dump_on_death`.

    Also swaps the recorder in as THE bus span sink: a replaced recorder
    is unhooked, so back-to-back train runs in one process (tests, the
    train→test CLI mode) never stack stale sinks."""
    global _INSTALLED
    with _INSTALL_LOCK:
        prev = _INSTALLED
        _INSTALLED = recorder
    from seist_tpu_torch.obs.bus import BUS

    if prev is not None:
        BUS.remove_span_sink(prev.on_span)
    if recorder is not None:
        BUS.add_span_sink(recorder.on_span)
    return prev


def get() -> Optional[FlightRecorder]:
    return _INSTALLED


def dump_on_death(
    reason: str, dedup_s: float = 0.0, arm_dedup: bool = True, **fields
) -> Optional[str]:
    """Dump the installed recorder (no-op without one). Never raises:
    every caller is a death path where the exit matters more than the
    artifact. ``dedup_s > 0`` skips when another FATAL dump landed
    within that window — the ``hard_exit`` funnel passes it so a path
    that already dumped with a richer reason (stall trip with thread
    stacks) doesn't leave a second, poorer file for the same death.

    ``arm_dedup=False`` marks a NON-fatal dump (bad-update rollback —
    the run continues): it never suppresses a later fatal dump. Without
    this, a rollback followed within seconds by the crash it caused
    would swallow the crash record — the one file carrying the actual
    error."""
    global _LAST_DUMP_MONO
    rec = _INSTALLED
    if rec is None:
        return None
    now = time.monotonic()
    if (
        dedup_s > 0
        and _LAST_DUMP_MONO is not None
        and now - _LAST_DUMP_MONO < dedup_s
    ):
        return None
    if "path" in fields:
        # ``path`` is :meth:`FlightRecorder.dump`'s file-location
        # parameter — a payload field of that name would silently
        # redirect the dump file to an arbitrary location. Remap it.
        fields["path_field"] = fields.pop("path")
    try:
        path = rec.dump(reason, **fields)
    except Exception:  # noqa: BLE001 - death path: the exit must proceed
        return None
    if arm_dedup:
        _LAST_DUMP_MONO = now
    if path:
        DUMPED.append(path)
    return path
