"""The port's logger (counterpart of ``seist_tpu/utils/logger.py``):
``logger.info(...)`` to stdout with the JAX package's line format, and the
process's log directory (:func:`logdir`), where the telemetry plane writes
its flight-recorder dumps, event logs and profiler traces. The train entry
sets it to the run's directory; elsewhere it is ``./logs``."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FMT = "%(asctime)s | %(levelname)s | %(message)s"


def _console_logger(name: str) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(logging.INFO)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FMT))
        lg.addHandler(handler)
    return lg


logger = _console_logger("seist_tpu_torch")

_LOGDIR: Optional[str] = None


def set_logdir(path: str) -> None:
    """Make ``path`` (created) the process's log directory."""
    global _LOGDIR
    os.makedirs(path, exist_ok=True)
    _LOGDIR = os.path.abspath(path)


def logdir() -> str:
    """The process's log directory: the one :func:`set_logdir` set, else
    ``./logs`` (created)."""
    if _LOGDIR is None:
        set_logdir("./logs")
    return _LOGDIR
