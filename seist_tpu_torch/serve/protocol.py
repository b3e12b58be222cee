"""Wire protocol of the port's server (its own copy of
``seist_tpu/serve/protocol.py``): request parsing, the options, and the
error taxonomy the HTTP front end maps to status codes. A predict request
body is::

    {"model": "seist_l_dpk",              # optional when one model is loaded
     "data": [[...], ...],                # (C, L) or (L, C) floats
     "tasks": ["dpk", "emg"],             # task groups only; default all
     "station": {"id": "STA1"},           # optional; echoed back
     "options": {"ppk_threshold": 0.3, "spk_threshold": 0.3,
                 "det_threshold": 0.5, "min_peak_dist": 1.0,
                 "sampling_rate": 50, "norm_mode": "std",
                 "max_events": 8, "timeout_ms": 5000,
                 "priority": "interactive", "variant": "fp32"}}

Windows shorter than the model's window are right-padded with zeros AFTER
normalization; longer ones are rejected toward ``POST /annotate``, which
takes a record of any length at least one window long (options
``stride``, ``combine`` and ``record_max_events``). ``POST /stream``
takes one packet of a station's stream (``station`` required, ``seq``,
``end``). A reload request (``POST /admin/reload``) is ``{"model": ...,
"checkpoint": PATH | "checkpoints": {task: PATH}, "version": N}``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class ServeError(Exception):
    """Base service error; ``status`` is the HTTP status it maps to."""

    status = 500
    code = "internal"

    def payload(self) -> Dict[str, Any]:
        return {"error": self.code, "message": str(self)}

    def headers(self) -> Dict[str, str]:
        """Extra HTTP response headers (the shed path's ``Retry-After``)."""
        return {}


class BadRequest(ServeError):
    status = 400
    code = "bad_request"


class UnknownModel(ServeError):
    status = 404
    code = "unknown_model"


class QueueFull(ServeError):
    """Bounded-queue backpressure; clients retry with backoff."""

    status = 429
    code = "queue_full"


class DeadlineExceeded(ServeError):
    status = 504
    code = "deadline_exceeded"


class ShuttingDown(ServeError):
    """The server is draining (SIGTERM), or its stream mux is closed
    (``MuxClosed``): nothing is wrong with the request, and a router
    retries it on another replica, which restores the station's session
    from its journal."""

    status = 503
    code = "shutting_down"


class IncompatibleCheckpoint(ServeError):
    """The checkpoint's state dict does not fit the model (a missing or
    unexpected key, a shape or dtype mismatch). Raised by the loader before
    anything serves or swaps, naming the first mismatching key."""

    status = 400
    code = "incompatible_checkpoint"


class ReloadFailed(ServeError):
    """A hot reload (``POST /admin/reload``) was refused or died before the
    swap: the incumbent entry keeps serving, unchanged."""

    status = 409
    code = "reload_failed"


class ParityGateFailed(ReloadFailed):
    """A reload candidate failed a load-time gate (a variant's parity
    against fp32, or the finite fp32 probe)."""

    code = "parity_gate_failed"


#: Serving weight variants (``serve/aot.py`` builds and parity-gates them):
#: fp32 = the weights as loaded; bf16 = weights, statistics and activations
#: cast; int8 = weight-only quantization. Chosen per request by
#: ``options.variant``; a variant that is not loaded, or that failed its
#: parity gate, is a 400.
VARIANTS = ("fp32", "bf16", "int8")
DEFAULT_VARIANT = "fp32"

#: Priority tiers, highest first; the order is the shed order reversed:
#: ``batch`` (backfill) is shed first under overload, ``alert`` (the
#: stream's early-warning windows) last. The number is the batcher's rank.
PRIORITIES = {"alert": 0, "interactive": 1, "batch": 2}
DEFAULT_PRIORITY = "interactive"


class Overloaded(ServeError):
    """Load shedding (``serve/shed.py``): the queue delay says this
    request's tier cannot be served within its budget. A policy drop of a
    low tier, answered 503 with ``Retry-After`` (QueueFull's 429 stays
    the hard bound of the queue)."""

    status = 503
    code = "shed"

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        # The shed policy owns the floor (ShedConfig.min_retry_after_s).
        self.retry_after_s = max(0.0, float(retry_after_s))

    def payload(self) -> Dict[str, Any]:
        p = super().payload()
        p["retry_after_s"] = round(self.retry_after_s, 1)
        return p

    def headers(self) -> Dict[str, str]:
        # Retry-After is delta-seconds, integral (RFC 9110).
        return {"Retry-After": str(int(math.ceil(self.retry_after_s)))}


@dataclass
class PredictOptions:
    """Per-request knobs."""

    ppk_threshold: float = 0.3
    spk_threshold: float = 0.3
    det_threshold: float = 0.5
    min_peak_dist: float = 1.0  # seconds
    sampling_rate: int = 50
    norm_mode: str = "std"
    max_events: int = 8
    timeout_ms: float = 5000.0
    priority: str = DEFAULT_PRIORITY  # admission tier (serve/shed.py)
    variant: str = DEFAULT_VARIANT  # weight variant (serve/aot.py)
    # /annotate (and /stream's session) only:
    stride: int = 0  # 0 = window // 2
    combine: str = "max"
    record_max_events: int = 0  # 0 = scale with the record's length

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "PredictOptions":
        if d is not None and not isinstance(d, dict):
            raise BadRequest(f"'options' must be an object, got {type(d).__name__}")
        d = dict(d or {})
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:
            raise BadRequest(f"unknown options: {sorted(unknown)}")
        for key, value in d.items():
            if key in ("norm_mode", "combine", "priority", "variant"):
                if not isinstance(value, str):
                    raise BadRequest(f"option '{key}' must be a string")
                continue
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise BadRequest(
                    f"option '{key}' must be a number, got {type(value).__name__}"
                )
            if not math.isfinite(value):
                raise BadRequest(f"option '{key}' must be finite")
            if key in ("sampling_rate", "max_events", "stride", "record_max_events"):
                if float(value) != int(value):
                    raise BadRequest(f"option '{key}' must be an integer, got {value}")
                d[key] = int(value)
        opts = cls(**d)
        if opts.timeout_ms <= 0:
            raise BadRequest(f"timeout_ms must be > 0, got {opts.timeout_ms}")
        if opts.sampling_rate <= 0:
            raise BadRequest(f"sampling_rate must be > 0, got {opts.sampling_rate}")
        if opts.min_peak_dist < 0:
            raise BadRequest(f"min_peak_dist must be >= 0, got {opts.min_peak_dist}")
        if opts.max_events < 1:
            raise BadRequest(f"max_events must be >= 1, got {opts.max_events}")
        if opts.stride < 0 or opts.record_max_events < 0:
            raise BadRequest("stride and record_max_events must be >= 0")
        if opts.combine not in ("max", "mean"):
            raise BadRequest(f"combine must be 'max' or 'mean', got '{opts.combine}'")
        if opts.priority not in PRIORITIES:
            raise BadRequest(
                f"priority must be one of {sorted(PRIORITIES)}, got '{opts.priority}'")
        if opts.variant not in VARIANTS:
            raise BadRequest(f"variant must be one of {list(VARIANTS)}, got '{opts.variant}'")
        return opts


def parse_tasks(obj: Any) -> Optional[Tuple[str, ...]]:
    """A request's ``tasks``: a non-empty list of unique task names, or None
    (a single-task request, or all of a group's tasks). Which tasks exist is
    the entry's call (``resolve_tasks``)."""
    if obj is None:
        return None
    if not isinstance(obj, (list, tuple)) or not obj:
        raise BadRequest(
            f"'tasks' must be a non-empty list of task names, got {type(obj).__name__}"
        )
    out: List[str] = []
    for t in obj:
        if not isinstance(t, str):
            raise BadRequest(f"'tasks' entries must be strings, got {type(t).__name__}")
        if t in out:
            raise BadRequest(f"duplicate task '{t}' in 'tasks'")
        out.append(t)
    return tuple(out)


def parse_body(raw: bytes) -> Dict[str, Any]:
    try:
        body = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise BadRequest(f"body is not valid JSON: {e}") from None
    if not isinstance(body, dict):
        raise BadRequest(f"body must be a JSON object, got {type(body).__name__}")
    return body


def parse_waveform(obj: Any, in_channels: int) -> np.ndarray:
    """JSON nested lists -> (L, C) float32, resolving (C, L) vs (L, C) by
    the model's channel count (ambiguous square inputs read as (L, C))."""
    try:
        arr = np.asarray(obj, dtype=np.float32)
    except (ValueError, TypeError) as e:
        raise BadRequest(f"'data' is not a numeric array: {e}") from None
    if arr.ndim != 2:
        raise BadRequest(f"'data' must be 2-D, got shape {arr.shape}")
    if arr.shape[1] == in_channels:
        pass
    elif arr.shape[0] == in_channels:
        arr = arr.T
    else:
        raise BadRequest(
            f"'data' shape {arr.shape} has no axis of {in_channels} channels"
        )
    if not np.all(np.isfinite(arr)):
        raise BadRequest("'data' contains non-finite values")
    return arr


_STATION_FIELDS = {"id", "network", "lat", "lon"}


def parse_station(obj: Any, required: bool = False) -> Optional[Dict[str, Any]]:
    """A request's ``station`` block: ``{"id": str, "network": str?, "lat":
    float?, "lon": float?}``, ``id`` mandatory, ``lat`` and ``lon``
    together or not at all (the associator needs both). Returns the
    normalized dict, or None when the block is absent and not required."""
    if obj is None:
        if required:
            raise BadRequest("'station' metadata is required: {'id': ...}")
        return None
    if not isinstance(obj, dict):
        raise BadRequest(f"'station' must be an object, got {type(obj).__name__}")
    unknown = set(obj) - _STATION_FIELDS
    if unknown:
        raise BadRequest(f"unknown station fields: {sorted(unknown)}")
    sid = obj.get("id")
    if not isinstance(sid, str) or not sid:
        raise BadRequest("'station.id' must be a non-empty string")
    if len(sid) > 64:
        # Journal file names slug the id; a bounded id keeps them apart.
        raise BadRequest("'station.id' must be <= 64 characters")
    out: Dict[str, Any] = {"id": sid, "network": ""}
    net = obj.get("network")
    if net is not None:
        if not isinstance(net, str):
            raise BadRequest("'station.network' must be a string")
        out["network"] = net
    lat, lon = obj.get("lat"), obj.get("lon")
    if (lat is None) != (lon is None):
        raise BadRequest("'station.lat' and 'station.lon' must come together")
    if lat is not None:
        for key, val in (("lat", lat), ("lon", lon)):
            if isinstance(val, bool) or not isinstance(val, (int, float)) \
                    or not math.isfinite(val):
                raise BadRequest(f"'station.{key}' must be a finite number")
        if not -90.0 <= float(lat) <= 90.0:
            raise BadRequest("'station.lat' out of range [-90, 90]")
        if not -180.0 <= float(lon) <= 360.0:
            raise BadRequest("'station.lon' out of range [-180, 360]")
        out["lat"], out["lon"] = float(lat), float(lon)
    return out


def json_bytes(payload: Dict[str, Any]) -> bytes:
    return json.dumps(payload, default=_jsonable).encode("utf-8")


def _jsonable(x: Any):
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not JSON-serializable: {type(x)}")
