"""Wire protocol of the port's server (its own copy of the parts of
``seist_tpu/serve/protocol.py`` that ``/predict`` uses): request parsing,
the options, and the error taxonomy the HTTP front end maps to status
codes. A predict request body is::

    {"model": "seist_l_dpk",              # optional when one model is loaded
     "data": [[...], ...],                # (C, L) or (L, C) floats
     "options": {"ppk_threshold": 0.3, "spk_threshold": 0.3,
                 "det_threshold": 0.5, "min_peak_dist": 1.0,
                 "sampling_rate": 50, "norm_mode": "std",
                 "max_events": 8, "timeout_ms": 5000}}

Windows shorter than the model's window are right-padded with zeros AFTER
normalization; longer ones are rejected.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np


class ServeError(Exception):
    """Base service error; ``status`` is the HTTP status it maps to."""

    status = 500
    code = "internal"

    def payload(self) -> Dict[str, Any]:
        return {"error": self.code, "message": str(self)}


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
    """The server is draining (SIGTERM): nothing is wrong with the request."""

    status = 503
    code = "shutting_down"


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

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "PredictOptions":
        if d is not None and not isinstance(d, dict):
            raise BadRequest(f"'options' must be an object, got {type(d).__name__}")
        d = dict(d or {})
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:
            raise BadRequest(f"unknown options: {sorted(unknown)}")
        for key, value in d.items():
            if key == "norm_mode":
                if not isinstance(value, str):
                    raise BadRequest(f"option '{key}' must be a string")
                continue
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise BadRequest(
                    f"option '{key}' must be a number, got {type(value).__name__}"
                )
            if not math.isfinite(value):
                raise BadRequest(f"option '{key}' must be finite")
            if key in ("sampling_rate", "max_events"):
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
        return opts


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
