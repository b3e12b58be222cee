"""The port's logger (counterpart of ``seist_tpu/utils/logger.py``):
``logger.info(...)`` to stdout with the JAX package's line format. The
per-phase log files (train/test) arrive with the training slice."""

from __future__ import annotations

import logging
import sys

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
