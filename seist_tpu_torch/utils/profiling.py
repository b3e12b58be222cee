"""Profiler captures and the interval stopwatch (counterpart of
``seist_tpu/utils/profiling.py``).

:func:`trace_start` / :func:`trace_stop` (and :func:`trace` around a
block) run ``torch.profiler`` over the CPU and, on a card, CUDA
activities, and write the capture as a Chrome trace (``trace.json``, read
by Perfetto or ``chrome://tracing``) into the directory given, as
``jax.profiler`` writes its trace there. :func:`trace_stop` synchronises
the card first, as the JAX package blocks on the last step before it
stops, so the capture holds the device work of every step it saw.

A capture must not start while a CUDA graph is being captured
(``torch.profiler`` would enqueue work into the capture): the train
worker opens its window two calls after the step's graph capture
(``--profile-steps``), and :func:`trace_start` refuses otherwise.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterator, Optional

_ACTIVE = None  # (profiler, directory) of the capture in progress
TRACE_FILE = "trace.json"


def trace_start(logdir: str) -> None:
    """Begin a ``torch.profiler`` capture that :func:`trace_stop` writes
    into ``logdir``: the form for windows that span loop iterations."""
    global _ACTIVE
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _ACTIVE is not None:
        raise RuntimeError(f"a profiler capture is already running ({_ACTIVE[1]})")
    cuda = torch.cuda.is_available()
    if cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("cannot start a profiler capture during a CUDA graph capture")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    _ACTIVE = (prof, logdir)


def active() -> bool:
    """Whether a capture is running."""
    return _ACTIVE is not None


def trace_stop() -> Optional[str]:
    """Synchronise the card, stop the capture and write it; returns the
    trace file's path (None when no capture runs)."""
    global _ACTIVE
    import torch

    if _ACTIVE is None:
        return None
    prof, logdir = _ACTIVE
    _ACTIVE = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """``with trace(dir):`` captures everything inside."""
    trace_start(logdir)
    try:
        yield
    finally:
        trace_stop()


@contextlib.contextmanager
def stopwatch() -> Iterator[Callable[[], float]]:
    """``with stopwatch() as elapsed:``: ``elapsed()`` returns the seconds
    since entry, inside the block and after it; the metrics bus's clock
    (``obs/bus.py::stopwatch``)."""
    from seist_tpu_torch.obs.bus import stopwatch as _stopwatch

    with _stopwatch() as elapsed:
        yield elapsed
